"""The port on the card: the CUDA ``mpe_lookup``, ``mpe_qat``, flash
attention, embedding-bag, segment-sum, Adam and tiered cold-fill kernels
against their plain PyTorch versions, their wrappers' checks and launch counts, the backwards'
repeatability, the engine on the card against the engine on the CPU, DLRM
and SASRec training and BST serving and training that go through the
kernels, the trainer's in-place step and its peak memory, and the serving
cells captured as CUDA graphs: replays against the eager step, the kernel
a replay runs, in-place table swaps, steady memory, a capture that fails;
the tiered cells' replays against their eager steps and the monolithic
cells, and tier moves, writebacks and refreshes that keep every bound
tensor where it was; the segment sum where hot segments meet wide rows,
over a million chunks and in the bag form; the LM's ``kv_cache_write``
(bit for bit) and ``decode_attention`` kernels against their plain
versions over a grid, at the attention kernel's chunk edges and long
contexts, in a graph at any length, and its decode cells against the CPU
engine; the
LM's training path: ``mpe_qat`` on rows wider than 256 (the token table's
2,048), the Adam pass on bf16 leaves, a reduced LM's Trainer step against
the same step on the CPU, and an MoE training step that runs no library
scatter-add.

Every test here needs a CUDA card and the CUDA toolkit; the ``cuda_device``
fixture skips them elsewhere. The file imports no JAX, so it runs on a
machine that has only the port's dependencies:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import gc

import numpy as np
import pytest
import torch

from repro_torch.cache import DecayAdmissionPolicy, TieredTableStore
from repro_torch.configs.dlrm_criteo import make_config
from repro_torch.core.inference import build_packed_table
from repro_torch.core.mpe import MPEConfig
from repro_torch.data.synthetic import CTRSpec, DriftingCTR, SyntheticCTR
from repro_torch.configs.bst import make_config as bst_config
from repro_torch.configs.sasrec import make_config as sasrec_config
from repro_torch.embeddings import embedding_bag
from repro_torch.kernels import embedding_bag_kernel
from repro_torch.kernels.embedding_bag import ops as bag_ops
from repro_torch.kernels.embedding_bag.ref import (embedding_bag_bwd_ref,
                                                   embedding_bag_ref)
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ref import bwd_ref, fwd_stats_ref
from repro_torch.kernels.mpe_lookup import ops
from repro_torch.kernels.mpe_lookup.ref import packed_lookup_ref
from repro_torch.kernels.mpe_qat import ops as qat_ops
from repro_torch.kernels.mpe_qat.ref import (mixed_expectation_bwd_ref,
                                             mixed_expectation_fwd_ref)
from repro_torch.kernels.adam import ops as adam_ops
from repro_torch.kernels.adam.ref import adam_step_ref_
from repro_torch.kernels.segment_sum import ops as seg_ops
from repro_torch.kernels.segment_sum.ref import segment_sum_ref
from repro_torch.kernels.tiered_cold import ops as cold_ops
from repro_torch.kernels.tiered_cold.ref import cold_fill_ref
from repro_torch.launch import train as launch_train
from repro_torch.launch.serve import (build_engine, build_packed_dlrm,
                                      packed_master, repack_tools)
from repro_torch.configs.base import get_arch
from repro_torch.data.tokens import TokenStream
from repro_torch.models.bst import BST
from repro_torch.models.lm import LM
from repro_torch.models.dlrm import DLRM
from repro_torch.models.dlrm import DLRMConfig
from repro_torch.embeddings.table import FieldSpec
from repro_torch.models.sasrec import SASRec
from repro_torch.nn.attention import MHA
from repro_torch.serve import (CellCache, Engine, RequestBatcher,
                               headroom_capacities)
from repro_torch.train.loop import Trainer
from repro_torch.train.optimizer import adam
from repro_torch.train.tree import leaves, tree_map, unflatten

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _table(rng, bits, n, d, device):
    emb = torch.from_numpy(rng.normal(0, 3e-3, (n, d)).astype(np.float32))
    widx = torch.from_numpy(rng.integers(0, len(bits), n).astype(np.int32))
    alpha = torch.from_numpy(rng.uniform(5e-4, 2e-3, len(bits)).astype(np.float32))
    beta = torch.from_numpy(rng.normal(0, 1e-4, d).astype(np.float32))
    return build_packed_table(emb.to(device), widx.to(device), alpha.to(device),
                              beta.to(device), MPEConfig(bits=tuple(bits)))


def _ids(rng, n, size, device):
    return torch.from_numpy(rng.integers(0, n, size).astype(np.int32)).to(device)


def test_kernel_matches_plain_over_grid(cuda_device, rng):
    for b in range(1, 9):
        for d in (8, 16, 50, 64):
            table, meta = _table(rng, (0, b), 200, d, cuda_device)
            ids = _ids(rng, 200, 333, cuda_device)
            got = ops.packed_lookup(table, meta, ids)
            torch.cuda.synchronize()
            want = packed_lookup_ref(table, meta, ids)
            torch.testing.assert_close(got, want, rtol=1e-6, atol=0)


def test_kernel_multi_bucket_and_dropped_rows(cuda_device, rng):
    bits = (0, 1, 2, 3, 4, 5, 6, 7, 8)
    table, meta = _table(rng, bits, 5000, 16, cuda_device)
    ids = _ids(rng, 5000, (64, 39), cuda_device)
    got = ops.packed_lookup(table, meta, ids)
    assert got.shape == (64, 39, 16)
    want = packed_lookup_ref(table, meta, ids.reshape(-1)).reshape(got.shape)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
    dropped = table["width_idx"][ids.long()] == 0
    assert bool(dropped.any()) and bool((got[dropped] == 0).all())


def test_kernel_counts_each_launch(cuda_device, rng):
    table, meta = _table(rng, (0, 3), 100, 16, cuda_device)
    before = ops.packed_lookup.launches
    ops.packed_lookup(table, meta, _ids(rng, 100, 10, cuda_device))
    ops.packed_lookup(table, meta, _ids(rng, 100, 10, cuda_device))
    assert ops.packed_lookup.launches == before + 2
    empty = ops.packed_lookup(table, meta,
                              torch.zeros(0, dtype=torch.int32,
                                          device=cuda_device))
    assert empty.shape == (0, 16)
    assert ops.packed_lookup.launches == before + 2


def test_kernel_rejects_what_it_does_not_take(cuda_device, rng):
    table, meta = _table(rng, (0, 4), 100, 16, cuda_device)
    ids = _ids(rng, 100, 8, cuda_device)
    with pytest.raises(TypeError):
        ops.packed_lookup(table, meta, ids.long())
    cpu_table = {k: (v.cpu() if torch.is_tensor(v) else
                     {s: w.cpu() for s, w in v.items()})
                 for k, v in table.items()}
    with pytest.raises(ValueError, match="lies on"):
        ops.packed_lookup(cpu_table, meta, ids)
    strided = dict(table, subtables={"b4": table["subtables"]["b4"].repeat(1, 2)[:, ::2]})
    with pytest.raises(ValueError, match="contiguous"):
        ops.packed_lookup(strided, meta, ids)
    with pytest.raises(ValueError, match="shape"):
        ops.packed_lookup(dict(table, beta=table["beta"][:8]), meta, ids)


def _kernel_names(fn, attempts: int = 3) -> list:
    """The names of the device kernels ``fn()`` runs, under the profiler.
    A profile that recorded no device activity at all (the profiler now and
    then returns none for a short window) is taken again."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(attempts):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        events = [e.name for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        if events:
            break
    return [name for name in events if not name.startswith(("Memcpy",
                                                            "Memset"))]


LOOKUP_EDGE_BITS = [(0, 1, 2, 3, 4, 5, 6, 7, 8), (0, 9, 16, 17, 31), (0, 6)]


@pytest.mark.parametrize("d", [16, 32, 50])
def test_lookup_kernel_bit_identical_at_every_bucket_and_edge(cuda_device,
                                                              rng, d):
    """Every width bucket including 0 and widths up to 31, rows whose word
    count is odd (16-byte unaligned: d = 16 at b = 6 or 5 words, d = 50 at
    b = 3), and id counts that do not fill the last warp or block: the
    kernel equals the plain version bit for bit."""
    odd = []
    for bits in LOOKUP_EDGE_BITS:
        table, meta = _table(rng, bits, 3000, d, cuda_device)
        odd += [w for w in ops.cached_plan(table, meta, cuda_device)
                .words_per_row if w % 2]
        for n_ids in (1, 31, 33, 255, 257, 4099):
            ids = _ids(rng, 3000, n_ids, cuda_device)
            got = ops.packed_lookup(table, meta, ids)
            torch.cuda.synchronize()
            assert torch.equal(got, packed_lookup_ref(table, meta, ids)), \
                (bits, n_ids)
        dropped = table["width_idx"][ids.long()] == 0
        assert bool(dropped.any()) and not got[dropped].any()
    assert odd, "no row width with an odd word count"


def test_lookup_kernel_offsets_past_two_to_the_31(cuda_device, rng):
    """More than 2^31 output elements (134,217,857 ids at d = 16, an 8.6 GB
    output): the rows at both ends equal the plain version's."""
    d = 16
    table, meta = _table(rng, (0, 3, 6), 5000, d, cuda_device)
    n_ids = 2 ** 31 // d + 129
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    ids = torch.randint(0, 5000, (n_ids,), generator=gen, device=cuda_device,
                        dtype=torch.int32)
    got = ops.packed_lookup(table, meta, ids)
    torch.cuda.synchronize()
    assert got.numel() > 2 ** 31
    for part in (slice(0, 4096), slice(n_ids - 4096, n_ids)):
        assert torch.equal(got[part], packed_lookup_ref(table, meta, ids[part]))
    del got


def test_lookup_serves_rows_written_in_place(cuda_device, rng):
    """After a subtable, ``width_idx``, α or β is written in place, the next
    call serves the new rows (a new launch descriptor), and a table whose
    tensors are replaced likewise."""
    table, meta = _table(rng, (0, 2, 4), 500, 16, cuda_device)
    ids = _ids(rng, 500, 777, cuda_device)
    first = ops.packed_lookup(table, meta, ids)
    plan = ops.cached_plan(table, meta, cuda_device)
    writes = [lambda: table["subtables"]["b4"].bitwise_xor_(0x5A5A5A5A),
              lambda: table["width_idx"].copy_((table["width_idx"] + 1) % 3),
              lambda: table["alpha"].mul_(2.0),
              lambda: table["beta"].add_(1e-3)]
    for write in writes:
        write()
        got = ops.packed_lookup(table, meta, ids)
        assert torch.equal(got, packed_lookup_ref(table, meta, ids))
        assert ops.cached_plan(table, meta, cuda_device) is not plan
        plan = ops.cached_plan(table, meta, cuda_device)
    assert not torch.equal(got, first)
    swapped = dict(table, subtables=dict(
        table["subtables"], b2=table["subtables"]["b2"].flip(0).contiguous()))
    torch.testing.assert_close(ops.packed_lookup(swapped, meta, ids),
                               packed_lookup_ref(swapped, meta, ids),
                               rtol=0, atol=0)


def test_one_lookup_call_launches_one_kernel(cuda_device, rng):
    table, meta = _table(rng, (0, 1, 2, 3, 4, 5, 6), 20_000, 16, cuda_device)
    ids = _ids(rng, 20_000, (512, 39), cuda_device)
    ops.packed_lookup(table, meta, ids)                  # builds, plans
    # counted outside the profiler, which takes a window again when it
    # recorded no device activity
    before = ops.packed_lookup.launches
    ops.packed_lookup(table, meta, ids)
    assert ops.packed_lookup.launches == before + 1
    names = _kernel_names(lambda: ops.packed_lookup(table, meta, ids))
    assert len(names) == 1 and "mpe_lookup_kernel" in names[0], names


def test_engine_on_card_matches_engine_on_cpu(cuda_device, rng):
    cfg = make_config(reduced=True)
    spec = CTRSpec(field_vocabs=tuple(f.vocab for f in cfg.fields), seed=1)
    freqs = SyntheticCTR(spec).expected_frequencies()
    params, buffers, state = DLRM.init(cfg, freqs, seed=1, device="cpu")
    cpu = build_engine(cfg, params, state, buffers, p99_rows=64,
                       bulk_rows=256, device="cpu")
    card = build_engine(cfg, params, state, buffers, p99_rows=64,
                        bulk_rows=256, device=cuda_device)
    ids = SyntheticCTR(spec._replace(batch_size=300)).batch(5)["ids"]
    # the card's cells are CUDA graphs: their replays launch the kernel
    before = card.cache.launches()["mpe_lookup"]
    got = card.score(ids, return_logits=True)
    assert card.cache.launches()["mpe_lookup"] > before
    np.testing.assert_allclose(got, cpu.score(ids, return_logits=True),
                               rtol=1e-4, atol=1e-4)


def test_model_init_defaults_to_the_card(cuda_device):
    params, buffers, _ = DLRM.init(make_config(reduced=True), seed=0)
    assert params["mlp"]["layers"][0]["kernel"].device.type == "cuda"
    assert params["embedding"]["width_idx"].device.type == "cuda"
    assert buffers["offsets"].device.type == "cuda"


def _qat_inputs(rng, t, d, bits, device, onehot=False):
    m = len(bits)
    rows = rng.normal(0, 3e-3, (t, d))
    if onehot:
        probs = np.eye(m)[rng.integers(0, m, t)]
    else:
        z = np.exp(rng.normal(0, 1, (t, m)))
        probs = z / z.sum(-1, keepdims=True)
    alpha = np.asarray([4e-3 / max(b, 1) for b in bits]) * rng.uniform(0.7, 1.3, m)
    beta = rng.normal(0, 1e-4, d)
    g = rng.normal(0, 1, (t, d))
    return [torch.from_numpy(x.astype(np.float32)).to(device)
            for x in (rows, probs, alpha, beta, g)]


@pytest.mark.parametrize("onehot", [False, True], ids=["softmax", "onehot"])
def test_qat_kernels_match_plain_over_grid(cuda_device, rng, onehot):
    """out and drows bit-identical to the plain version (the same FMAs);
    dprobs, dalpha, dbeta, summed in float64 in another order, at rtol 1e-4 /
    atol 1e-6. The grid has one width alone, b = 1..8 (the LSQ and ALPT
    baselines' lookups: probability 1)."""
    grid = ([(0, 1, 2, 3, 4, 5, 6)] + [(0, b) for b in range(1, 9)]
            + [(b,) for b in range(1, 9)] + [tuple(range(10)), (0, 23, 24)])
    for bits in grid:
        for d in (8, 16, 32, 33, 50, 64):
            for t in (1, 255, 257, 4099):
                rows, probs, alpha, beta, g = _qat_inputs(
                    rng, t, d, bits, cuda_device, onehot)
                out = qat_ops.mixed_expectation_fwd(rows, probs, alpha, beta, bits)
                got = qat_ops.mixed_expectation_bwd(rows, probs, alpha, beta, g,
                                                    bits)
                torch.cuda.synchronize()
                want_out = mixed_expectation_fwd_ref(rows, probs, alpha, beta, bits)
                want = mixed_expectation_bwd_ref(rows, probs, alpha, beta, g, bits,
                                                 sum_dtype=torch.float64)
                torch.testing.assert_close(out, want_out, rtol=0, atol=0)
                torch.testing.assert_close(got[0], want[0], rtol=0, atol=0)
                for x, w in zip(got[1:], want[1:]):
                    torch.testing.assert_close(x, w, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("d", [16, 32, 50])
def test_qat_backward_is_repeatable(cuda_device, rng, d):
    bits = (0, 1, 2, 3, 4, 5, 6)
    rows, probs, alpha, beta, g = _qat_inputs(rng, 100_003, d, bits, cuda_device)
    first = qat_ops.mixed_expectation_bwd(rows, probs, alpha, beta, g, bits)
    again = qat_ops.mixed_expectation_bwd(rows, probs, alpha, beta, g, bits)
    for x, y in zip(first, again):
        assert torch.equal(x, y)


def test_qat_kernels_count_and_reject(cuda_device, rng):
    bits = (0, 2, 4)
    rows, probs, alpha, beta, g = _qat_inputs(rng, 50, 16, bits, cuda_device)
    fwd0 = qat_ops.mixed_expectation_fwd.launches
    bwd0 = qat_ops.mixed_expectation_bwd.launches
    leaves = [x.clone().requires_grad_(True) for x in (rows, probs, alpha, beta)]
    qat_ops.mixed_expectation_kernel(*leaves, bits).backward(g)
    assert qat_ops.mixed_expectation_fwd.launches == fwd0 + 1
    assert qat_ops.mixed_expectation_bwd.launches == bwd0 + 1
    assert all(x.grad is not None and x.grad.is_cuda for x in leaves)
    with pytest.raises(ValueError, match="lies on"):
        qat_ops.mixed_expectation_fwd(rows, probs.cpu(), alpha, beta, bits)
    with pytest.raises(TypeError):
        qat_ops.mixed_expectation_fwd(rows.double(), probs, alpha, beta, bits)


def test_training_launches_the_qat_kernels(cuda_device):
    fwd0 = qat_ops.mixed_expectation_fwd.launches
    bwd0 = qat_ops.mixed_expectation_bwd.launches
    res = launch_train.main(["--reduced", "--steps", "3", "--retrain-steps", "2",
                             "--batch", "256"])
    assert qat_ops.mixed_expectation_fwd.launches - fwd0 >= 5
    assert qat_ops.mixed_expectation_bwd.launches - bwd0 == 5
    history = res["search_history"] + res["retrain_history"]
    assert len(history) == 5 and not any(h["skipped"] for h in history)
    assert all(np.isfinite(h["loss"]) for h in history)
    assert res["packed_table"]["width_idx"].is_cuda


def _flash_counts():
    return (flash_ops.flash_attention_fwd.launches,
            flash_ops.flash_attention_fwd_stats.launches,
            flash_ops.flash_attention_bwd.launches)


def _normal(rng, shape, device, n):
    return [torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32)).to(device)
            for _ in range(n)]


def _heads_first(x):
    """(B, S, H, hd) -> (B·H, S, hd); lse (B, H, S) -> (B·H, S)."""
    if x.ndim == 4:
        b, s, h, hd = x.shape
        return x.transpose(1, 2).reshape(b * h, s, hd)
    return x.reshape(-1, x.shape[-1])


@pytest.mark.parametrize("heads", [1, 8, 16])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_flash_kernels_match_plain(cuda_device, rng, causal, heads):
    """o and lse within 3e-5, dq, dk, dv within 2e-4 of the plain versions
    (the reference's contracts); the backward repeats bit for bit. Through
    the (BH, S, hd) wrappers, then through ``flash_attention`` and the
    wrappers on (B, S, H, hd) with H = ``heads``: BST's (S 21, hd 4) and
    SASRec's (S 50, hd 50) shapes, and S 64, 65 and 128 on both sides of the
    staged route's end (S <= 64). S = 256 takes four key tiles, so dq sums
    across tiles. At H = 16 the LM's heads of 128 on the tiled route: S
    65, 100 and 127 (a partial key tile), 384 and 1,024 (the causal
    backward's key tiles each walk a different number of query steps)."""
    for bh, s, hd in [(1, 8, 4), (3, 50, 50), (2, 64, 16), (3, 128, 64),
                      (2, 256, 128), (37, 32, 50)]:
        q, k, v, do = _normal(rng, (bh, s, hd), cuda_device, 4)
        o = flash_ops.flash_attention_fwd(q, k, v, causal)
        o2, lse = flash_ops.flash_attention_fwd_stats(q, k, v, causal)
        grads = flash_ops.flash_attention_bwd(q, k, v, o2, lse, do, causal)
        again = flash_ops.flash_attention_bwd(q, k, v, o2, lse, do, causal)
        torch.cuda.synchronize()
        want_o, want_lse = fwd_stats_ref(q, k, v, causal)
        torch.testing.assert_close(o, want_o, rtol=3e-5, atol=3e-5)
        assert torch.equal(o, o2)
        torch.testing.assert_close(lse, want_lse, rtol=3e-5, atol=3e-5)
        want = bwd_ref(q, k, v, o2, lse, do, causal)
        for x, w, y in zip(grads, want, again):
            torch.testing.assert_close(x, w, rtol=2e-4, atol=2e-4)
            assert torch.equal(x, y)
    shapes = ([(2, s, 128) for s in (65, 100, 127, 384, 1024)] if heads == 16
              else [(3, 21, 4), (2, 50, 50), (2, 64, 16), (2, 65, 50),
                    (1, 128, 4)])
    for b, s, hd in shapes:
        q, k, v, do = _normal(rng, (b, s, heads, hd), cuda_device, 4)
        flat = [_heads_first(x) for x in (q, k, v, do)]
        o = flash_ops.flash_attention_fwd(q, k, v, causal)
        o2, lse = flash_ops.flash_attention_fwd_stats(q, k, v, causal)
        assert o.shape == q.shape and lse.shape == (b, heads, s)
        grads = flash_ops.flash_attention_bwd(q, k, v, o2, lse, do, causal)
        again = flash_ops.flash_attention_bwd(q, k, v, o2, lse, do, causal)
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
        out = flash_ops.flash_attention(*leaves, causal=causal)
        out.backward(do)
        torch.cuda.synchronize()
        want_o, want_lse = fwd_stats_ref(*flat[:3], causal)
        torch.testing.assert_close(_heads_first(o), want_o, rtol=3e-5, atol=3e-5)
        assert torch.equal(o, o2) and torch.equal(out, o)
        torch.testing.assert_close(_heads_first(lse), want_lse, rtol=3e-5,
                                   atol=3e-5)
        want = bwd_ref(*flat[:3], _heads_first(o2), _heads_first(lse),
                       flat[3], causal)
        for x, w, y, leaf in zip(grads, want, again, leaves):
            torch.testing.assert_close(_heads_first(x), w, rtol=2e-4, atol=2e-4)
            assert torch.equal(x, y) and torch.equal(leaf.grad, x)


def test_flash_attention_makes_no_copies(cuda_device, rng):
    """Under ``torch.no_grad()`` ``flash_attention`` on (B, S, 8, hd) raises
    the peak of requested device memory by o's bytes and nothing more: no
    transposed copy of q, k, v or o, on either route (S 384 is tiled).
    Requested bytes, not allocated ones: the caching allocator may hand
    out a free block up to 1 MB larger than asked, and count it whole."""
    def requested(stat):
        return torch.cuda.memory_stats()[f"requested_bytes.all.{stat}"]
    for b, s, hd in [(64, 21, 4), (16, 50, 50), (2, 384, 128)]:
        q, k, v = _normal(rng, (b, s, 8, hd), cuda_device, 3)
        flash_ops.flash_attention_fwd(q, k, v, False)   # builds and loads
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = requested("current")
        with torch.no_grad():
            o = flash_ops.flash_attention(q, k, v, causal=False)
        torch.cuda.synchronize()
        grown = requested("peak") - before
        assert o.shape == q.shape and o.is_contiguous()
        assert grown <= o.numel() * 4, (grown, o.numel() * 4)


def test_flash_kernels_reject_what_they_do_not_take(cuda_device, rng):
    q, k, v = _normal(rng, (2, 16, 8), cuda_device, 3)
    with pytest.raises(TypeError):
        flash_ops.flash_attention_fwd(q.double(), k, v)
    with pytest.raises(ValueError, match="lies on"):
        flash_ops.flash_attention_fwd(q, k.cpu(), v)
    with pytest.raises(ValueError, match="contiguous"):
        flash_ops.flash_attention_fwd(q, k.transpose(1, 2).contiguous()
                                      .transpose(1, 2), v)
    wide = torch.zeros(1, 8, 129, device=cuda_device)
    with pytest.raises(ValueError, match="hd=129"):
        flash_ops.flash_attention_fwd(wide, wide, wide)


def test_mha_launches_the_plain_forward_without_grad(cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    params = MHA.init(gen, 50, 1, head_dim=50)
    x = torch.randn((4, 50, 50), generator=gen, device=cuda_device)
    kw = dict(n_heads=1, n_kv_heads=1, head_dim=50, rope_theta=None)
    before = _flash_counts()
    with torch.no_grad():
        out, _ = MHA.apply(params, x, **kw)
    assert np.subtract(_flash_counts(), before).tolist() == [1, 0, 0]
    cpu = {k: {"kernel": p["kernel"].cpu()} for k, p in params.items()}
    want, _ = MHA.apply(cpu, x.cpu(), **kw)
    torch.testing.assert_close(out.cpu(), want, rtol=3e-5, atol=3e-5)

    leaves = [p["kernel"].requires_grad_(True) for p in params.values()]
    before = _flash_counts()
    out, _ = MHA.apply(params, x, **kw)
    out.square().sum().backward()
    assert np.subtract(_flash_counts(), before).tolist() == [0, 1, 1]
    assert all(p.grad is not None and p.grad.is_cuda for p in leaves)


def test_mha_training_step_at_eight_heads_launches_stats_and_backward(
        cuda_device):
    """One ``MHA`` training step at BST's head shape (8 heads of width 4,
    not causal) launches the forward with stats and the backward once each
    and the plain forward never; the gradients match the same step on the
    CPU."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    params = MHA.init(gen, 32, 8, head_dim=4)
    x = torch.randn((16, 21, 32), generator=gen, device=cuda_device)
    kw = dict(n_heads=8, n_kv_heads=8, head_dim=4, causal=False, rope_theta=None)
    leaves = [p["kernel"].requires_grad_(True) for p in params.values()]
    before = _flash_counts()
    out, _ = MHA.apply(params, x, **kw)
    out.square().sum().backward()
    assert np.subtract(_flash_counts(), before).tolist() == [0, 1, 1]
    cpu = {k: {"kernel": p["kernel"].detach().cpu().requires_grad_(True)}
           for k, p in params.items()}
    want, _ = MHA.apply(cpu, x.cpu(), **kw)
    want.square().sum().backward()
    torch.testing.assert_close(out.detach().cpu(), want.detach(), rtol=3e-5,
                               atol=3e-5)
    for name, p in params.items():
        torch.testing.assert_close(p["kernel"].grad.cpu(),
                                   cpu[name]["kernel"].grad, rtol=2e-4,
                                   atol=2e-4)


def test_sasrec_training_launches_the_flash_and_qat_kernels(cuda_device, rng):
    cfg = sasrec_config(reduced=True)
    params, buffers, state = SASRec.init(cfg, seed=0, device=cuda_device)

    def loss_fn(p, bu, st, batch, *, step=None):
        return SASRec.loss_fn(p, bu, st, batch, cfg, lam=1e-5, step=step)

    trainer = Trainer(loss_fn, params, buffers, state, adam(1e-3))
    seq = rng.integers(0, cfg.item_vocab, (32, cfg.seq_len + 1)).astype(np.int32)
    batch = {"seq_ids": seq[:, :-1], "pos_ids": seq[:, 1:],
             "neg_ids": rng.integers(0, cfg.item_vocab,
                                     (32, cfg.seq_len)).astype(np.int32),
             "mask": np.ones((32, cfg.seq_len), np.float32)}
    flash0 = _flash_counts()
    qat0 = (qat_ops.mixed_expectation_fwd.launches,
            qat_ops.mixed_expectation_bwd.launches)
    trainer.run(lambda step: batch, 2, log_every=0)
    assert np.subtract(_flash_counts(), flash0).tolist() == [0, 4, 4]
    assert [qat_ops.mixed_expectation_fwd.launches - qat0[0],
            qat_ops.mixed_expectation_bwd.launches - qat0[1]] == [6, 6]
    assert all(np.isfinite(h["loss"]) and not h["skipped"]
               for h in trainer.history)


BAG_TOL = dict(rtol=1e-5, atol=1e-6)   # the reference's bag kernel contract


def _bag_inputs(rng, b, l, d, device, *, n=300, id_dtype=torch.int32,
                float_mask=False):
    table = torch.from_numpy(rng.normal(0, 1, (n, d)).astype(np.float32))
    ids = torch.from_numpy(rng.integers(0, n, (b, l))).to(id_dtype)
    mask = torch.from_numpy(rng.random((b, l)) < 0.7)
    mask[: max(b // 4, 1)] = False                  # all-masked bags
    if float_mask:
        mask = mask * torch.from_numpy(rng.uniform(0.5, 1.5, (b, l))).float()
    return table.to(device), ids.to(device), mask.to(device)


BAG_SHAPES = [(1, 1, 4), (4, 3, 16), (16, 7, 32), (33, 20, 50), (8, 50, 64),
              (1024, 20, 32), (5, 40, 128)]


@pytest.mark.parametrize("id_dtype", [torch.int32, torch.int64],
                         ids=["int32", "int64"])
@pytest.mark.parametrize("float_mask", [False, True], ids=["bool", "weights"])
def test_bag_kernel_matches_plain(cuda_device, rng, id_dtype, float_mask):
    """Forward and backward within rtol 1e-5 / atol 1e-6 of the plain
    versions; both repeat bit for bit; an all-masked bag is 0."""
    for b, l, d in BAG_SHAPES:
        table, ids, mask = _bag_inputs(rng, b, l, d, cuda_device,
                                       id_dtype=id_dtype,
                                       float_mask=float_mask)
        g = torch.randn((b, d), device=cuda_device)
        out = bag_ops.embedding_bag_fwd(table, ids, mask)
        again = bag_ops.embedding_bag_fwd(table, ids, mask)
        grad = bag_ops.embedding_bag_bwd(g, ids, mask, table.shape[0])
        grad2 = bag_ops.embedding_bag_bwd(g, ids, mask, table.shape[0])
        torch.cuda.synchronize()
        torch.testing.assert_close(out, embedding_bag_ref(table, ids, mask),
                                   **BAG_TOL)
        torch.testing.assert_close(
            grad, embedding_bag_bwd_ref(g, ids, mask, table.shape[0]),
            **BAG_TOL)
        assert torch.equal(out, again) and torch.equal(grad, grad2)
        assert not out[: max(b // 4, 1)].any()


def test_bag_kernel_counts_each_launch_and_never_takes_plain(cuda_device, rng,
                                                             monkeypatch):
    """A CUDA tensor launches the kernel (one count per forward; the
    backward counts one segment-sum launch); the plain version is never
    called, through the kernel API or ``embeddings.embedding_bag``."""
    def refuse(*args):
        raise AssertionError("a CUDA tensor took the plain version")

    monkeypatch.setattr(bag_ops, "embedding_bag_ref", refuse)
    monkeypatch.setattr(bag_ops, "embedding_bag_bwd_ref", refuse)
    table, ids, mask = _bag_inputs(rng, 64, 20, 32, cuda_device)
    leaf = table.clone().requires_grad_(True)
    before = bag_ops.embedding_bag_fwd.launches
    seg_before = seg_ops.segment_sum.launches
    out = embedding_bag_kernel(leaf, ids, mask)
    out.square().sum().backward()
    assert bag_ops.embedding_bag_fwd.launches == before + 1
    assert seg_ops.segment_sum.launches == seg_before + 1
    assert leaf.grad is not None and leaf.grad.is_cuda
    for combine in ("sum", "mean"):
        embedding_bag(table, ids, mask, combine=combine)
    embedding_bag(table, ids, None, combine="sum")
    assert bag_ops.embedding_bag_fwd.launches == before + 4
    embedding_bag(table, ids, mask, combine="max")       # plain torch
    assert bag_ops.embedding_bag_fwd.launches == before + 4


def test_bag_kernel_rejects_what_it_does_not_take(cuda_device, rng):
    table, ids, mask = _bag_inputs(rng, 8, 5, 16, cuda_device)
    with pytest.raises(TypeError):
        bag_ops.embedding_bag_fwd(table.double(), ids, mask)
    with pytest.raises(TypeError):
        bag_ops.embedding_bag_fwd(table, ids.to(torch.int16), mask)
    with pytest.raises(ValueError, match="lies on"):
        bag_ops.embedding_bag_fwd(table, ids.cpu(), mask)
    with pytest.raises(ValueError, match="contiguous"):
        bag_ops.embedding_bag_fwd(table, ids.t().contiguous().t(), mask)
    with pytest.raises(ValueError, match="one \\(B, L\\) shape"):
        bag_ops.embedding_bag_fwd(table, ids, mask[:, :3])


def test_bag_backward_is_one_segment_sum_and_no_library_sum(cuda_device,
                                                             rng):
    """The bag's backward on the card launches the segment sum's bag form
    once and runs no kernel of the library's dense embedding backward; it
    equals the segment sum of the products written out (the same sums in
    the same order) bit for bit."""
    table, ids, mask = _bag_inputs(rng, 4096, 20, 32, cuda_device, n=20_000,
                                   float_mask=True)
    leaf = table.clone().requires_grad_(True)
    g = torch.randn((4096, 32), device=cuda_device)
    embedding_bag_kernel(leaf, ids, mask)                # builds
    # counted outside the profiler, which takes a window again when it
    # recorded no device activity (and so runs the backward twice)
    before = seg_ops.segment_sum.launches
    torch.autograd.grad(embedding_bag_kernel(leaf, ids, mask), leaf, g)
    assert seg_ops.segment_sum.launches == before + 1
    names = _kernel_names(lambda: torch.autograd.grad(
        embedding_bag_kernel(leaf, ids, mask), leaf, g))
    assert any("segment_chunk_kernel" in n for n in names), names
    library = [n for n in names if seg_ops.is_library_scatter_add(n)]
    assert not library, library
    (got,) = torch.autograd.grad(embedding_bag_kernel(leaf, ids, mask), leaf, g)
    prods = (g[:, None, :] * mask[..., None]).reshape(-1, 32)
    assert torch.equal(got, seg_ops.segment_sum(prods, ids.reshape(-1),
                                                table.shape[0]))


def test_bag_forward_is_bit_repeatable(cuda_device, rng):
    """At the BST training batch's shape (65,536 bags of 20, d = 32) the
    forward gives the same bits three times."""
    table, ids, mask = _bag_inputs(rng, 65_536, 20, 32, cuda_device,
                                   n=1_000_000)
    outs = [bag_ops.embedding_bag_fwd(table, ids, mask) for _ in range(3)]
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])
    torch.testing.assert_close(outs[0], embedding_bag_ref(table, ids, mask),
                               **BAG_TOL)


def _bst_batch(rng, cfg, n):
    ctx = [f.vocab for f in cfg.ctx_fields]
    return {"seq_ids": rng.integers(0, cfg.item_vocab,
                                    (n, cfg.seq_len)).astype(np.int32),
            "target_id": rng.integers(0, cfg.item_vocab, n).astype(np.int32),
            "ctx_ids": np.stack([rng.integers(0, v, n) for v in ctx],
                                axis=1).astype(np.int32),
            "label": rng.integers(0, 2, n).astype(np.int32)}


def test_bst_apply_and_training_launch_the_counted_kernels(cuda_device, rng):
    """Reduced BST on the card: an eval apply launches the plain flash
    forward once and the search lookup's ``mpe_qat`` forward twice (the
    sequence and the context fields), and matches the same model on the
    CPU; a training step launches the flash forward with stats and backward
    once each and ``mpe_qat`` forward and backward twice each."""
    cfg = bst_config(reduced=True)
    params, buffers, state = BST.init(cfg, seed=0, device=cuda_device)
    batch = {k: torch.from_numpy(v).to(cuda_device)
             for k, v in _bst_batch(rng, cfg, 32).items()}
    flash0 = _flash_counts()
    qat0 = qat_ops.mixed_expectation_fwd.launches
    with torch.no_grad():
        logits, _, _ = BST.apply(params, buffers, state, batch, cfg)
    assert np.subtract(_flash_counts(), flash0).tolist() == [1, 0, 0]
    assert qat_ops.mixed_expectation_fwd.launches - qat0 == 2
    want, _, _ = BST.apply(*(tree_map(lambda x: x.cpu(), tree) for tree in
                             (params, buffers, state, batch)), cfg)
    torch.testing.assert_close(logits.cpu(), want, rtol=1e-4, atol=1e-4)

    def loss_fn(p, bu, st, b, *, step=None):
        return BST.loss_fn(p, bu, st, b, cfg, lam=1e-5, step=step)

    trainer = Trainer(loss_fn, params, buffers, state, adam(1e-3))
    host = _bst_batch(rng, cfg, 32)
    flash0 = _flash_counts()
    qat0 = (qat_ops.mixed_expectation_fwd.launches,
            qat_ops.mixed_expectation_bwd.launches)
    trainer.run(lambda step: host, 2, log_every=0)
    assert np.subtract(_flash_counts(), flash0).tolist() == [0, 2, 2]
    assert [qat_ops.mixed_expectation_fwd.launches - qat0[0],
            qat_ops.mixed_expectation_bwd.launches - qat0[1]] == [4, 4]
    assert all(np.isfinite(h["loss"]) and not h["skipped"]
               for h in trainer.history)


def _hot_segment_case(rng, case):
    """(grad rows, ids, n, bag weights or None, the hot segments' least
    rows) of a ``test_segment_sum_kernel_matches_plain_on_a_hot_segment``
    case."""
    if case in ("1", "7", "32", "50"):
        # 1.5 M ids, 1.1 M of them in one segment (a Zipf-hot group or
        # item), the rest Zipf-spread over 200,000 rows
        t, n = 1_500_000, 200_000
        ids = (rng.zipf(1.2, t) % n).astype(np.int64)
        ids[rng.random(t) < 0.75] = 4321
        return t, int(case), ids, n, None, 1_000_000
    if case.startswith("dispatch"):
        # the MoE dispatch's backward: 61,440 slots into 8,192 tokens, every
        # unused slot's id 0 (one hot segment of > 50,000 rows)
        t, n = 61_440, 8_192
        ids = np.zeros(t, np.int64)
        used = rng.random(t) < 0.15
        ids[used] = rng.integers(1, n, int(used.sum()))
        return t, int(case.split()[1]), ids, n, None, 50_000
    if case == "combine 2048":
        # the combine gather's backward: 49,152 choices into 61,440 slots,
        # the dropped ones on each of 64 experts' last slot
        e, cap, t = 64, 960, 49_152
        expert = rng.integers(0, e, t)
        keep = rng.random(t) < 0.25
        ids = np.where(keep, expert * cap + rng.integers(0, cap - 1, t),
                       expert * cap + cap - 1).astype(np.int64)
        return t, 2048, ids, e * cap, None, 400
    if case == "million chunks":
        # 64 M ids (over a million chunks of 64) in short segments, three
        # long ones among them: few chunks hold a long segment's start
        t, n = 64_000_123, 4_000_000
        ids = rng.integers(0, n, t)
        for hot, share in ((17, 0.002), (n // 2, 0.0005), (n - 1, 0.001)):
            ids[rng.random(t) < share] = hot
        return t, 1, ids, n, None, 30_000
    # the bag form at width 256: 4,096 bags of 20, a third of the slots on
    # one row
    b, l, n = 4096, 20, 5000
    ids = rng.integers(0, n, (b, l))
    ids[rng.random((b, l)) < 0.33] = 77
    weights = ((rng.random((b, l)) < 0.8) * rng.uniform(0.5, 1.5, (b, l)))
    return b, 256, ids, n, weights.astype(np.float32), 20_000


@pytest.mark.parametrize("case", ["1", "7", "32", "50", "dispatch 256",
                                  "dispatch 1433", "dispatch 2048",
                                  "combine 2048", "million chunks",
                                  "bag 256"])
def test_segment_sum_kernel_matches_plain_on_a_hot_segment(cuda_device, rng,
                                                            case):
    """The gather's backward where hot segments meet the kernel's edges:
    a 1.1 M-row segment at narrow widths; the MoE dispatch's > 50,000-row
    segment at widths 256, 1,433 (five 256-column tiles and one of 153) and
    2,048; the combine gather's 64 hot slots at 2,048; over a million
    chunks of short segments with three long ones; the bag form at 256.
    Within rtol 1e-6 / atol 1e-6 of the plain version (both sum in float64
    and round once, in other orders), twice bit-identical, every untouched
    row 0, one launch a call."""
    rows, w, ids, n, weights, hot = _hot_segment_case(rng, case)
    ids = torch.from_numpy(ids).to(cuda_device)
    grad = torch.randn((rows, w), device=cuda_device)
    bag = (None if weights is None
           else torch.from_numpy(weights).to(cuda_device))
    before = seg_ops.segment_sum.launches
    got = seg_ops.segment_sum(grad, ids, n, bag_weights=bag)
    again = seg_ops.segment_sum(grad, ids, n, bag_weights=bag)
    torch.cuda.synchronize()
    assert seg_ops.segment_sum.launches == before + 2
    assert int(torch.bincount(ids.reshape(-1)).max()) >= hot
    if bag is not None:
        grad = (grad[:, None, :] * bag[..., None]).reshape(-1, w)
    want = segment_sum_ref(grad, ids.reshape(-1), n)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    assert torch.equal(got, again)
    untouched = torch.bincount(ids.reshape(-1), minlength=n) == 0
    assert not got[untouched].any()


def test_segment_sum_kernel_on_two_segments(cuda_device, rng):
    """QR's remainder table: 2.5 M ids in two segments of ~1.25 M rows each
    (k = 2), width 16: within rtol 1e-6 / atol 1e-6 of the plain version,
    twice bit-identical."""
    t = 2_500_000
    ids = torch.from_numpy(rng.integers(0, 2, t)).to(cuda_device)
    grad = torch.randn((t, 16), device=cuda_device)
    got = seg_ops.segment_sum(grad, ids, 2)
    again = seg_ops.segment_sum(grad, ids, 2)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, segment_sum_ref(grad, ids, 2), rtol=1e-6,
                               atol=1e-6)
    assert torch.equal(got, again)


def test_gather_launches_the_segment_sum_backward(cuda_device, rng):
    table = torch.randn((1000, 7), device=cuda_device, requires_grad=True)
    ids = torch.from_numpy(rng.integers(0, 1000, 5000)).to(cuda_device)
    before = seg_ops.segment_sum.launches
    out = seg_ops.gather(table, ids)
    assert torch.equal(out, table.detach()[ids])
    g = torch.randn_like(out)
    out.backward(g)
    assert seg_ops.segment_sum.launches == before + 1
    torch.testing.assert_close(table.grad, segment_sum_ref(g, ids, 1000),
                               rtol=1e-6, atol=1e-6)
    with pytest.raises(TypeError):
        seg_ops.segment_sum(g.double(), ids, 1000)
    with pytest.raises(ValueError, match="lie on"):
        seg_ops.segment_sum(g, ids.cpu(), 1000)


@pytest.mark.parametrize("moments", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_adam_pass_matches_the_plain_chain_bit_for_bit(cuda_device, rng,
                                                       moments):
    """The fused pass against ``optimizer.py``'s chain of torch calls on the
    card, bit for bit, on a table and a bias (no weight decay); a step
    whose flag is false leaves all three tensors bit-unchanged."""
    hyper = dict(lr=1e-3, b1=0.9, b2=0.999, eps=1e-8, weight_decay=3e-6)
    step = torch.full((), 7.0, device=cuda_device)
    bc1 = 1 - torch.pow(torch.full((), 0.9, device=cuda_device), step)
    bc2 = 1 - torch.pow(torch.full((), 0.999, device=cuda_device), step)
    scale = torch.full((), 0.37, device=cuda_device)
    for shape in [(100_003, 16), (513,)]:
        p, g = (torch.from_numpy(rng.normal(0, s, shape).astype(np.float32))
                .to(cuda_device) for s in (1.0, 3.0))
        m = torch.from_numpy(rng.normal(0, 0.1, shape).astype(np.float32)
                             ).to(cuda_device, moments)
        v = torch.from_numpy(rng.uniform(0, 0.1, shape).astype(np.float32)
                             ).to(cuda_device, moments)
        for ok in (True, False):
            ok_t = torch.full((), ok, device=cuda_device)
            got = [x.clone() for x in (p, m, v)]
            want = [x.clone() for x in (p, m, v)]
            before = adam_ops.adam_step_.launches
            adam_ops.adam_step_(*got[:1], g, *got[1:], scale, ok_t, bc1, bc2,
                                **hyper)
            assert adam_ops.adam_step_.launches == before + 1
            adam_step_ref_(*want[:1], g, *want[1:], scale, ok_t, bc1, bc2,
                           **hyper)
            for x, y, x0 in zip(got, want, (p, m, v)):
                assert torch.equal(x, y)
                assert torch.equal(x, x0) != ok


@pytest.mark.parametrize("weight_decay", [0.0, 3e-6])
def test_adam_pass_with_a_schedules_rate(cuda_device, rng, weight_decay):
    """A schedule's ``lr_t`` (a float32 on the card) read by the pass from
    device memory, its decay factor f32(lr_t·wd) formed in float32: bit for
    bit the plain chain's, over rates where f32(lr_t·wd) and f32(lr·wd)
    differ; a skipped step keeps every bit."""
    hyper = dict(b1=0.9, b2=0.999, eps=1e-8, weight_decay=weight_decay)
    bc1 = torch.full((), 0.1, device=cuda_device)
    bc2 = torch.full((), 0.001, device=cuda_device)
    scale = torch.full((), 0.37, device=cuda_device)
    for lr in (1e-3, 3e-3, 7.25e-4):
        lr_t = torch.full((), lr, device=cuda_device)
        for shape in [(100_003, 16), (4099,), (2, 3)]:
            p, g = (torch.from_numpy(rng.normal(0, s, shape).astype(np.float32))
                    .to(cuda_device) for s in (1.0, 3.0))
            m = torch.from_numpy(rng.normal(0, 0.1, shape).astype(np.float32)
                                 ).to(cuda_device)
            v = torch.from_numpy(rng.uniform(0, 0.1, shape).astype(np.float32)
                                 ).to(cuda_device)
            for ok in (True, False):
                ok_t = torch.full((), ok, device=cuda_device)
                got = [x.clone() for x in (p, m, v)]
                want = [x.clone() for x in (p, m, v)]
                adam_ops.adam_step_(got[0], g, got[1], got[2], scale, ok_t,
                                    bc1, bc2, lr=lr_t, **hyper)
                adam_step_ref_(want[0], g, want[1], want[2], scale, ok_t, bc1,
                               bc2, lr=lr_t, **hyper)
                for x, y, x0 in zip(got, want, (p, m, v)):
                    assert torch.equal(x, y)
                    assert torch.equal(x, x0) != ok
    with pytest.raises(ValueError, match="lr must be"):
        adam_ops.adam_step_(p, g, m, v, scale, ok_t, bc1, bc2,
                            lr=lr_t.double(), **hyper)


def test_one_width_lookups_launch_the_qat_kernels(cuda_device, rng):
    """LSQ (b = 6) and ALPT (b = 8, β = 0) look up through ``mpe_qat`` at
    one width, forward and backward once a call, equal to their plain
    versions on the CPU within the reference's contracts (out rtol 1e-5 /
    atol 1e-7, gradients rtol 1e-4 / atol 1e-6)."""
    from repro_torch.core.api import get_compressor
    ids = torch.from_numpy(rng.integers(0, 5000, (4096, 3))).to(cuda_device)
    g = torch.randn((4096, 3, 16), device=cuda_device)
    for name, cfg in (("lsq", {"bits": 6}), ("alpt", {"bits": 8})):
        comp = get_compressor(name)
        params, _ = comp.init(torch.Generator(device=cuda_device).manual_seed(0),
                              5000, 16, None, cfg)
        outs, grads = {}, {}
        for dev in (cuda_device, torch.device("cpu")):
            p = {k: v.to(dev).requires_grad_(True) for k, v in params.items()}
            before = (qat_ops.mixed_expectation_fwd.launches,
                      qat_ops.mixed_expectation_bwd.launches)
            out = comp.lookup(p, {}, ids.to(dev), cfg, train=True)
            grads[dev.type] = torch.autograd.grad((out * g.to(dev)).sum(),
                                                  list(p.values()))
            outs[dev.type] = out.detach().cpu()
            if dev.type == "cuda":
                assert (qat_ops.mixed_expectation_fwd.launches - before[0],
                        qat_ops.mixed_expectation_bwd.launches - before[1]) == (1, 1)
        torch.testing.assert_close(outs["cuda"], outs["cpu"], rtol=1e-5,
                                   atol=1e-7)
        for x, y in zip(grads["cuda"], grads["cpu"]):
            torch.testing.assert_close(x.cpu(), y, rtol=1e-4, atol=1e-6)


def _dlrm_with_a_large_table(device):
    """A DLRM whose table (4 x 1,000,000 x 16 = 256 MB) dwarfs the rest."""
    fields = tuple(FieldSpec(f"f{i}", 1_000_000) for i in range(4))
    cfg = DLRMConfig(fields=fields, d_embed=16, mlp_hidden=(64, 32),
                     backbone="dnn", compressor="mpe_search",
                     comp_cfg=MPEConfig(lam=3e-5)._asdict())
    spec = CTRSpec(field_vocabs=tuple(f.vocab for f in fields),
                   batch_size=4096, seed=0)
    ds = SyntheticCTR(spec)
    params, buffers, state = DLRM.init(cfg, ds.expected_frequencies(), seed=0,
                                       device=device)

    def loss_fn(p, bu, st, batch, *, step=None):
        return DLRM.loss_fn(p, bu, st, batch, cfg, lam=3e-5, step=step)
    return Trainer(loss_fn, params, buffers, state, adam(1e-3)), ds


def test_trainer_step_updates_in_place_and_skips_exactly(cuda_device):
    """On the card, a step leaves every parameter and moment leaf at its
    ``data_ptr`` with new values and launches the Adam pass once a leaf; a
    step whose loss is not finite leaves every leaf and Adam's step
    bit-unchanged."""
    trainer, ds = _dlrm_with_a_large_table(cuda_device)
    trainer.run(ds.batch, 1, log_every=0)
    carry = leaves([trainer.params, trainer.carry["opt"]])
    ptrs = [x.data_ptr() for x in carry]
    before = [x.clone() for x in carry]
    launches = adam_ops.adam_step_.launches
    trainer.run(ds.batch, 2, log_every=0)
    assert adam_ops.adam_step_.launches - launches == len(leaves(trainer.params))
    after = leaves([trainer.params, trainer.carry["opt"]])
    assert [x.data_ptr() for x in after] == ptrs
    assert not torch.equal(after[0], before[0])
    assert int(trainer.carry["opt"]["step"]) == 2
    loss_fn = trainer.loss_fn

    def nan_loss(*args, **kw):
        loss, aux = loss_fn(*args, **kw)
        return loss * torch.nan, aux
    trainer.loss_fn = nan_loss
    before = [x.clone() for x in after]
    out = trainer.train_step({k: torch.from_numpy(np.asarray(v)).to(cuda_device)
                              for k, v in ds.batch(2).items()}, 2)
    assert bool(out["skipped"])
    for x, y in zip(leaves([trainer.params, trainer.carry["opt"]]), before):
        assert torch.equal(x, y)
    assert int(trainer.carry["opt"]["step"]) == 2


def test_trainer_step_peak_memory_is_under_five_and_a_half_tables(
        cuda_device):
    """One step of a DLRM whose table dwarfs the rest peaks at five tables'
    bytes and the small rest: the table, its two Adam moments, its gradient
    and the clip's square of the gradient (one leaf at a time); nothing of
    a second tree (the tree route held nine and more)."""
    # from a clean card: no other test's graphs, nor the cuBLAS workspace
    # of the streams they were captured on
    gc.collect()
    torch._C._cuda_clearCublasWorkspaces()
    torch.cuda.empty_cache()
    trainer, ds = _dlrm_with_a_large_table(cuda_device)
    trainer.run(ds.batch, 1, log_every=0)
    table = trainer.params["embedding"]["emb"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    trainer.run(ds.batch, 2, log_every=0)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    ratio = peak / (table.numel() * table.element_size())
    assert ratio < 5.5, ratio


def _graph_engine(device, *, headroom=None):
    """The reduced DLRM's random packed table (optionally repacked with
    headroom) behind 64/256-row cells on ``device``."""
    cfg = make_config(reduced=True)
    params, buffers, state, spec = build_packed_dlrm(cfg, seed=1,
                                                     device=device)
    master = packed_master(cfg, seed=1, device=device)
    if headroom is not None:
        emb = master["final_params"]["embedding"]
        params["embedding"], _ = build_packed_table(
            emb["emb"], torch.from_numpy(master["feature_bits_idx"]),
            emb["alpha"], emb["beta"], MPEConfig(bits=cfg.comp_cfg["bits"]),
            row_capacities=headroom_capacities(master["packed_meta"],
                                               fraction=headroom))
    engine = build_engine(cfg, params, state, buffers, p99_rows=64,
                          bulk_rows=256, device=device)
    return cfg, spec, (params, buffers, state), master, engine


def _padded(spec, rows, step):
    return SyntheticCTR(spec._replace(batch_size=rows)).batch(step)["ids"]


def test_replayed_cell_equals_the_eager_step_bit_for_bit(cuda_device):
    _, spec, _, _, engine = _graph_engine(cuda_device)
    for shape, rows in (("serve_p99", 64), ("serve_bulk", 256)):
        reg = engine._score[shape]
        x = reg.cell.stage(_padded(spec, rows, 7))
        for r in (reg, reg.lookup):
            got = r.cell.compiled(*x).clone()
            with torch.inference_mode():
                want = r.celldef.step_fn(*r.bound, *x)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (shape, r.celldef.kind)
            assert r.cell.replays == 1
            assert r.cell.captured == {"mpe_lookup": 1}
        # a short chunk is padded with rows of id 0 in the staging buffer,
        # over what a full one left there
        short = _padded(spec, 10, 8)
        x = reg.cell.stage(short)
        assert torch.equal(x[0].cpu(),
                           torch.from_numpy(RequestBatcher.pad(short, rows)[0]))


def test_a_profiled_replay_runs_the_lookup_kernel(cuda_device):
    _, spec, _, _, engine = _graph_engine(cuda_device)
    reg = engine._score["serve_p99"]
    x = reg.cell.stage(_padded(spec, 64, 3))
    before = ops.packed_lookup.launches
    for r in (reg, reg.lookup):
        # the profiler now and then drops part of a short window: take it
        # again, a few replays each time
        for _ in range(3):
            names = _kernel_names(
                lambda r=r: [r.cell.compiled(*x) for _ in range(5)])
            if any("mpe_lookup_kernel" in n for n in names):
                break
        assert any("mpe_lookup_kernel" in n for n in names), names
    assert ops.packed_lookup.launches == before       # no wrapper call
    assert engine.cache.launches()["mpe_lookup"] >= 2


def test_a_swap_is_seen_by_the_next_replay(cuda_device):
    cfg, spec, model, master, engine = _graph_engine(cuda_device,
                                                     headroom=0.5)
    ids = _padded(spec, 50, 11)
    old = engine.score(ids, return_logits=True)
    table = engine.live_packed_table()
    ptrs = [t.data_ptr() for t in leaves(table)]
    compiles = engine.compile_count
    freqs = SyntheticCTR(spec).expected_frequencies()
    planner, swapper = repack_tools(engine, master, freqs)
    gbits = np.asarray(master["group_bits"])
    plan = planner.plan_budget(gbits, int(0.6 * planner.bytes_packed(gbits)))
    new_table, _ = swapper.build(plan.feature_bits_idx)
    swapper.repack(plan)
    engine.sched_step()
    got = engine.score(ids, return_logits=True)
    assert engine.compile_count == compiles and engine.swaps_applied == 1
    assert [t.data_ptr() for t in leaves(table)] == ptrs
    params, buffers, state = model
    with torch.inference_mode():
        want = DLRM.apply(dict(params, embedding=new_table), buffers, state,
                          {"ids": torch.from_numpy(ids).to(cuda_device)},
                          cfg)[0].cpu().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    assert not np.array_equal(got, old)


def test_requests_move_neither_compiles_nor_reserved_bytes(cuda_device):
    cfg, spec, (params, buffers, state), _, engine = _graph_engine(
        cuda_device)
    twin = Engine(cache=engine.cache)
    twin.register_packed_model("dlrm", DLRM, cfg, params, state, buffers,
                               shapes={"serve_p99": 64, "serve_bulk": 256})
    assert engine.compile_count == 4 and engine.cache.hits == 4
    for e in (engine, twin):
        e.score(_padded(spec, 3, 1))
        e.score(_padded(spec, 200, 2))
    torch.cuda.synchronize()
    reserved = torch.cuda.memory_reserved()
    replays = sum(engine.cache.replays().values())
    for i, rows in enumerate((1, 64, 65, 256, 300, 600) * 4):
        for e in (engine, twin):
            e.submit(_padded(spec, rows, 100 + i))
        engine.drain()
        twin.drain()
    torch.cuda.synchronize()
    assert engine.compile_count == 4
    assert torch.cuda.memory_reserved() == reserved
    assert sum(engine.cache.replays().values()) > replays


def test_a_failed_capture_raises(cuda_device):
    cache = CellCache(cuda_device)

    def host_sync_step(ids):
        return ids * int(ids.sum().item())   # a host read inside the step
    with pytest.raises(RuntimeError, match="capturing"):
        cache.get_or_compile(cache.key("bad", "x@4"),
                             lambda: (host_sync_step, (),
                                      (((4, 3), torch.int32),), {}))
    assert cache.counters() == {"compiles": 0, "hits": 0, "cells": 0}
    assert torch.ones(3, device=cuda_device).sum().item() == 3.0


# -- the tiered cache: the cold-fill kernel, tiered cells, in-place moves ----

def _cold_case(rng, b, d, n_cold, device, extra=0):
    """A (0, b) table on ``device`` behind a store with nothing hot but the
    zero-width features, ``n_cold`` ids of cold features staged through the
    store, and the fill's buffer copied into one ``extra`` words longer
    whose tail is junk (the kernel must read its counts, not its length)."""
    table, meta = _table(rng, (0, b), 1000, d, device)
    freqs = rng.random(1000)
    store = TieredTableStore(table, meta, freqs, 0.0, device=device)
    cold = np.nonzero(~store._is_hot_np)[0]
    ids = rng.choice(cold, n_cold).astype(np.int32)
    fill = store.prefetch_cold(ids)
    buf = torch.from_numpy(rng.integers(-2**31, 2**31 - 1,
                                        fill.buffer.numel() + extra,
                                        dtype=np.int64).astype(np.int32))
    buf = buf.to(device)
    buf[:fill.buffer.numel()] = fill.buffer
    return store, meta, ids, buf


@pytest.mark.parametrize("b", range(1, 9))
@pytest.mark.parametrize("d", [8, 16, 50, 64])
def test_cold_fill_kernel_matches_plain(cuda_device, rng, b, d):
    for n_cold in (0, 1, 255, 4096):
        store, meta, ids, buf = _cold_case(rng, b, d, n_cold, cuda_device,
                                           extra=4096 * 3)
        out = torch.full((n_cold + 7, d), 3.0, device=cuda_device)
        want = cold_fill_ref(out.clone(), buf, meta["bits"], d,
                             store.hot["alpha"], store.hot["beta"])
        before = cold_ops.cold_fill.launches
        cold_ops.cold_fill(out, buf, meta, store.hot["alpha"],
                           store.hot["beta"])
        torch.cuda.synchronize()
        assert cold_ops.cold_fill.launches == before + 1
        assert torch.equal(out, want), (b, d, n_cold)
        # with the hot lookup's zeros under it: the monolithic lookup
        if n_cold:
            got = store.lookup(ids)
            table_ids = torch.from_numpy(ids).to(cuda_device)
            assert torch.equal(got, packed_lookup_ref(
                _store_table(store), meta, table_ids)), (b, d, n_cold)


def _store_table(store):
    """The monolithic packed table behind a store, rebuilt from its host
    mirror (what the store's lookups must equal)."""
    dev = store.device
    return {"subtables": {k: torch.from_numpy(v).to(dev)
                          for k, v in store._mirror.items()},
            "width_idx": torch.from_numpy(store._width_idx_np).to(dev),
            "local_idx": torch.from_numpy(store._local_idx_np).to(dev),
            "alpha": store.hot["alpha"], "beta": store.hot["beta"]}


def _staged_cold(rng, bits, counts, d, n_out, device, extra=0):
    """A staged buffer in the kernel's layout holding ``counts`` entries of
    each width of ``bits`` at distinct rows of an (n_out, d) output (rows
    ascending in each bucket, as ``prefetch_cold`` stages them), random
    packed words, then ``extra`` junk words."""
    from repro_torch.core.packing import words_per_row
    k = sum(counts)
    rows = rng.permutation(n_out)[:k]
    parts, start = [], 0
    for c in counts:
        parts.append(np.sort(rows[start:start + c]))
        start += c
    n_words = sum(c * words_per_row(d, b) for c, b in zip(counts, bits) if b)
    buf = rng.integers(-2**31, 2**31 - 1, len(bits) + k + n_words + extra,
                       dtype=np.int64).astype(np.int32)
    buf[:len(bits)] = counts
    if k:
        buf[len(bits):len(bits) + k] = np.concatenate(parts)
    return torch.from_numpy(buf).to(device)


def _cold_counts(rng, bits, tile):
    """Count patterns: every live width full; empty buckets between full
    ones; a total that ends in the middle of a tile; one entry in the last
    bucket."""
    live = [i for i, b in enumerate(bits) if b]
    full = [0] * len(bits)
    for i in live:
        full[i] = int(rng.integers(1, 300))
    gaps = [c if j % 2 else 0 for j, c in enumerate(full)]
    mid = [0] * len(bits)
    for j, i in enumerate(live):
        mid[i] = tile * (j % 3) + (tile // 2 + 1 if j == len(live) - 1 else 0)
    last = [0] * len(bits)
    last[live[-1]] = 1
    return [full, gaps, mid, last]


@pytest.mark.parametrize("d", [16, 50, 64])
@pytest.mark.parametrize("bits", [(0, 1, 2, 3, 4, 5, 6), tuple(range(16))],
                         ids=["dlrm_widths", "16_buckets"])
def test_cold_fill_kernel_over_many_buckets(cuda_device, rng, bits, d):
    """Several live widths in one buffer (DLRM's {0..6}, and 16 buckets up
    to 15 bits), empty buckets between full ones, totals that end mid-tile,
    one entry alone: bit for bit the plain version, one launch a call; a
    bad buffer (a negative count, more entries than the output, more words
    than the buffer, entries of the zero width) writes nothing."""
    tile = 256 // min((d + 3) // 4, 256)
    alpha = torch.from_numpy(rng.uniform(5e-4, 2e-3, len(bits))
                             .astype(np.float32)).to(cuda_device)
    beta = torch.from_numpy(rng.normal(0, 1e-4, d).astype(np.float32)
                            ).to(cuda_device)
    meta = {"bits": bits, "d": d}
    for counts in _cold_counts(rng, bits, tile):
        n_out = sum(counts) + 9
        buf = _staged_cold(rng, bits, counts, d, n_out, cuda_device,
                           extra=333)
        out = torch.full((n_out, d), 3.0, device=cuda_device)
        want = cold_fill_ref(out.clone(), buf, bits, d, alpha, beta)
        before = cold_ops.cold_fill.launches
        cold_ops.cold_fill(out, buf, meta, alpha, beta)
        torch.cuda.synchronize()
        assert cold_ops.cold_fill.launches == before + 1
        assert torch.equal(out, want), counts
    live = [i for i, b in enumerate(bits) if b]
    good = [0] * len(bits)
    good[live[-1]] = 40
    bad_counts = ([-1 if i == live[0] else c for i, c in enumerate(good)],
                  [50 if i == 0 else c for i, c in enumerate(good)])
    for counts in bad_counts:
        buf = _staged_cold(rng, bits, [max(c, 0) for c in counts], d, 100,
                           cuda_device)
        buf[:len(bits)] = torch.tensor(counts, dtype=torch.int32)
        out = torch.full((100, d), 3.0, device=cuda_device)
        cold_ops.cold_fill(out, buf, meta, alpha, beta)
        torch.cuda.synchronize()
        assert bool((out == 3.0).all()), counts
    # more entries than the output holds; more words than the buffer
    buf = _staged_cold(rng, bits, good, d, 100, cuda_device)
    out = torch.full((30, d), 3.0, device=cuda_device)
    cold_ops.cold_fill(out, buf, meta, alpha, beta)
    cut = buf[:len(bits) + 2 * 40]
    out2 = torch.full((100, d), 3.0, device=cuda_device)
    cold_ops.cold_fill(out2, cut, meta, alpha, beta)
    torch.cuda.synchronize()
    assert bool((out == 3.0).all()) and bool((out2 == 3.0).all())


@pytest.mark.parametrize("d", [16, 50])
def test_cold_fill_kernel_at_dlrm_widths_matches_the_lookup(cuda_device, rng,
                                                            d):
    """A (0..6)-width table behind a store that keeps nothing hot but the
    zero width: its lookups (the hot lookup's zeros, then the cold fill)
    equal the monolithic table's at counts around a tile."""
    table, meta = _table(rng, (0, 1, 2, 3, 4, 5, 6), 3000, d, cuda_device)
    store = TieredTableStore(table, meta, rng.random(3000), 0.0,
                             device=cuda_device)
    cold = np.nonzero(~store._is_hot_np)[0]
    whole = _store_table(store)
    for n in (1, 18, 19, 20, 63, 64, 65, 1000):
        ids = rng.choice(cold, n).astype(np.int32)
        got = store.lookup(ids)
        want = packed_lookup_ref(whole, meta,
                                 torch.from_numpy(ids).to(cuda_device))
        assert torch.equal(got, want), (d, n)


def test_cold_fill_kernel_rejects_what_it_does_not_take(cuda_device, rng):
    store, meta, _, buf = _cold_case(rng, 4, 16, 10, cuda_device)
    out = torch.zeros((10, 16), device=cuda_device)
    a, be = store.hot["alpha"], store.hot["beta"]
    with pytest.raises(TypeError):
        cold_ops.cold_fill(out, buf.float(), meta, a, be)
    with pytest.raises(ValueError):
        cold_ops.cold_fill(out, buf.cpu(), meta, a, be)
    with pytest.raises(ValueError):
        cold_ops.cold_fill(out[:, :8], buf, meta, a, be)


def _tiered_engine(device, hot_fraction=0.1):
    """The reduced DLRM's random packed table behind 64/256-row score and
    tiered cells on ``device``, the store at ``hot_fraction``."""
    cfg = make_config(reduced=True)
    params, buffers, state, spec = build_packed_dlrm(cfg, seed=1,
                                                     device=device)
    freqs = SyntheticCTR(spec).expected_frequencies()
    store = TieredTableStore(params["embedding"], buffers["embedding"]["meta"],
                             freqs, hot_fraction, device=device)
    engine = build_engine(cfg, params, state, buffers, p99_rows=64,
                          bulk_rows=256, store=store, device=device)
    return cfg, spec, (params, buffers, state), store, engine


@pytest.mark.parametrize("hot_fraction", [0.0, 0.1, 1.0])
def test_tiered_replay_equals_eager_and_the_monolithic_cell(cuda_device,
                                                           hot_fraction):
    cfg, spec, _, store, engine = _tiered_engine(cuda_device, hot_fraction)
    for shape, rows in (("tiered_p99", 64), ("tiered_bulk", 256)):
        tc = engine._tiered[shape]
        x, fill = tc.stage(_padded(spec, rows, 7))
        cold = tc.cold_input(fill)
        got = tc.reg.cell.compiled(x, cold).clone()
        with torch.inference_mode():
            want = tc.reg.celldef.step_fn(*tc.reg.bound, x, cold)
        torch.cuda.synchronize()
        assert torch.equal(got, want), shape
        assert tc.reg.cell.captured == {"mpe_lookup": 1, "tiered_cold": 1}
    for rows in (1, 64, 300, 600):
        ids = _padded(spec, rows, 20 + rows)
        a = engine.score_tiered(ids, return_logits=True, overlap=True)
        b = engine.score_tiered(ids, return_logits=True, overlap=False)
        np.testing.assert_array_equal(a, b)
        np.testing.assert_allclose(a, engine.score(ids, return_logits=True),
                                   rtol=0, atol=1e-6)
    assert engine.compile_count == 6


def test_tier_moves_writebacks_and_refresh_stay_in_place(cuda_device, rng):
    cfg, spec, (params, buffers, state), store, engine = _tiered_engine(
        cuda_device, 0.1)
    policy = engine.attach_tier_policy(
        DecayAdmissionPolicy(store.meta["n"], halflife=4.0, max_moves=64),
        every=1)
    bound = [t.data_ptr() for tc in engine._tiered.values()
             for t in leaves(tc.reg.bound) if torch.is_tensor(t)]
    hot = [t.data_ptr() for t in leaves(store.hot)]
    compiles = engine.compile_count
    drift = DriftingCTR(spec._replace(batch_size=100), shift_at=3,
                        shift_frac=0.4)
    master = packed_master(cfg, seed=1, device=cuda_device)
    emb = master["final_params"]["embedding"]["emb"].cpu().numpy()
    offs = buffers["offsets"].cpu().numpy()
    for step in range(8):
        ids = drift.batch(step)["ids"]
        engine.score_tiered(ids)
        gids = np.unique(ids.astype(np.int64) + offs[None, :])
        engine.writeback_embeddings(gids[:50], emb[gids[:50]])
    assert engine.tier_moves["promotions"] > 0
    assert store.counters()["writebacks"] > 0 and policy.observations > 0
    store.refresh(params["embedding"], buffers["embedding"]["meta"])
    engine.sched_step()
    assert [t.data_ptr() for tc in engine._tiered.values()
            for t in leaves(tc.reg.bound) if torch.is_tensor(t)] == bound
    assert [t.data_ptr() for t in leaves(store.hot)] == hot
    assert engine.compile_count == compiles
    ids = drift.batch(50)["ids"]
    got = engine.score_tiered(ids, return_logits=True)
    # the refresh re-seated the original table: the monolithic cells agree
    np.testing.assert_allclose(got, engine.score(ids, return_logits=True),
                               rtol=0, atol=1e-6)


def _ragged_segments(rng, t, n):
    """``t`` segment ids into ``n`` segments of ragged sizes: a hot one
    holding a third of the rows, the rest Zipf-spread, every fifth segment
    left empty."""
    seg = (rng.zipf(1.3, t) % n).astype(np.int64)
    seg[rng.random(t) < 0.33] = n // 2
    seg[seg % 5 == 4] = 0
    return seg


@pytest.mark.parametrize("w", [1, 64, 100, 257, 1433])
def test_scatter_sum_matches_plain_at_every_width(cuda_device, rng, w):
    """The scatter-sum forward at widths on both sides of the kernel's
    256-column tile (1,433 is cora's feature width: five full tiles and one
    of 153): bit-identical to the plain version (both sum in float64 and
    round once), twice bit-identical, one launch a call; its gradient is
    the gather of the cotangent. A tile's sums are the row's: the result
    equals the kernel run on each 256-column slice alone."""
    t, n = 40_000, 3_000
    seg = torch.from_numpy(_ragged_segments(rng, t, n)).to(cuda_device)
    x = torch.randn((t, w), device=cuda_device, requires_grad=True)
    before = seg_ops.segment_sum.launches
    got = seg_ops.scatter_sum(x, seg, n)
    again = seg_ops.scatter_sum(x, seg, n)
    torch.cuda.synchronize()
    assert seg_ops.segment_sum.launches == before + 2
    assert got.shape == (n, w)
    assert torch.equal(got, again)
    assert torch.equal(got, segment_sum_ref(x.detach(), seg, n))
    tiles = [seg_ops.segment_sum(x.detach()[:, c:c + 256].contiguous(), seg, n)
             for c in range(0, w, 256)]
    assert torch.equal(got, torch.cat(tiles, dim=1))
    g = torch.randn_like(got)
    (dx,) = torch.autograd.grad(got, x, g)
    assert torch.equal(dx, g[seg])


def _packed_two_tower(device, *, seed=0):
    """A small two-tower with a random packed table on ``device``: 2 user
    fields, 1 item field of 5,000 rows, d = 16, towers 32-16."""
    from repro_torch.models.two_tower import TwoTower, TwoTowerConfig
    cfg = TwoTowerConfig(
        user_fields=(FieldSpec("u0", 3000), FieldSpec("u1", 2000)),
        item_fields=(FieldSpec("i0", 5000),), d_embed=16,
        tower_hidden=(32, 16), compressor="packed",
        comp_cfg={"bits": (0, 1, 2, 3, 4, 5, 6), "d": 16, "n": 10_000,
                  "group_size": 16})
    params, buffers, state = TwoTower.init(cfg, seed=seed, device=device)
    meta = buffers["embedding"]["meta"]
    cfg = cfg._replace(comp_cfg={k: meta[k] for k in ("bits", "d", "n")})
    return TwoTower, cfg, params, buffers, state


def test_retrieve_replays_the_captured_cell(cuda_device, rng):
    """``Engine.retrieve`` on the card through a captured retrieval cell of
    4,096 candidates: a corpus of 10,000 goes in three chunks, each a
    replay holding one lookup a tower; the scores equal the same model's
    on the CPU (rtol 1e-4, atol 1e-5), the indices too where the scores
    are apart, and a replay equals the eager step bit for bit."""
    from repro_torch.serve import two_tower_retrieval_cell
    model, cfg, params, buffers, state = _packed_two_tower(cuda_device)
    engine = Engine(device=cuda_device)
    reg = engine.register(two_tower_retrieval_cell(
        model, cfg, params, state, buffers, n_cands=4096, top_k=10,
        arch="tt"))
    assert reg.cell.captured == {"mpe_lookup": 2}
    user = np.stack([rng.integers(0, v, 1) for v in (3000, 2000)],
                    1).astype(np.int32)
    cands = rng.integers(0, 5000, (10_000, 1)).astype(np.int32)
    before = ops.packed_lookup.launches
    scores, idx = engine.retrieve(user, cands)
    assert ops.packed_lookup.launches == before      # replays, no wrapper
    assert reg.cell.replays == 3
    assert engine.cache.launches()["mpe_lookup"] == 6
    cpu = [tree_map(lambda x: x.cpu() if torch.is_tensor(x) else x, t)
           for t in (params, buffers, state)]
    with torch.no_grad():
        want_s, want_i = model.retrieval_score(
            cpu[0], cpu[1], cpu[2], torch.from_numpy(user),
            torch.from_numpy(cands), cfg, top_k=10)
    np.testing.assert_allclose(scores, want_s.numpy(), rtol=1e-4, atol=1e-5)
    apart = np.abs(np.diff(want_s.numpy())) > 1e-4
    keep = np.concatenate([[True], apart]) & np.concatenate([apart, [True]])
    np.testing.assert_array_equal(idx[keep], want_i.numpy()[keep])
    x = reg.cell.stage(user, cands[:4096], np.ones((4096,), bool))
    got = [o.clone() for o in reg.cell.compiled(*x)]
    with torch.inference_mode():
        want = reg.celldef.step_fn(*reg.bound, *x)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_gin_molecule_steps_launch_the_counted_kernels(cuda_device):
    """Two GIN steps at full width (5 layers, d = 64, learnable ε) on the
    molecule cell under ``mpe_search``: each step launches the ``mpe_qat``
    forward and backward once, the segment sum 13 times (five message
    scatters and the pooling forward; five message gathers' and the
    lookup's two gathers' backwards) and the Adam pass once a leaf (31,
    five 0-d ε among them); finite losses, no step skipped, every ε
    moved."""
    from repro_torch.configs.base import get_arch
    from repro_torch.core.mpe import MPEConfig
    from repro_torch.data.graphs import make_molecule_batch
    from repro_torch.models.gnn import GIN
    cfg = get_arch("gin-tu").make_config(shape="molecule")
    cfg = cfg._replace(comp_cfg=MPEConfig(group_size=16)._asdict())
    params, buffers = GIN.init(cfg, seed=0, device=cuda_device)
    n_leaves = len(leaves(params))
    assert n_leaves == 31

    def loss_fn(p, bu, st, batch, *, step=None):
        graph = dict(batch, n_graphs=128)
        loss, ce = GIN.loss_fn(p, bu, graph, cfg, lam=3e-5, step=step)
        return loss, (st, ce)

    def data(step):
        b = make_molecule_batch(128, 30, 64, atom_vocab=119, seed=step)
        b.pop("n_graphs")
        return b

    trainer = Trainer(loss_fn, params, buffers, {}, adam(3e-3))
    names = ("mixed_expectation_fwd", "mixed_expectation_bwd")
    for step in range(2):
        before = {"seg": seg_ops.segment_sum.launches,
                  "adam": adam_ops.adam_step_.launches,
                  **{k: getattr(qat_ops, k).launches for k in names}}
        trainer.run(data, step + 1, log_every=0)
        torch.cuda.synchronize()
        assert seg_ops.segment_sum.launches - before["seg"] == 13
        assert adam_ops.adam_step_.launches - before["adam"] == n_leaves
        for k in names:
            assert getattr(qat_ops, k).launches - before[k] == 1
    assert all(np.isfinite(h["loss"]) and not h["skipped"]
               for h in trainer.history)
    assert all(float(layer["eps"]) != 0.0
               for layer in trainer.params["layers"])


# -- the LM's decode kernels -----------------------------------------------

LM_DTYPES = {"int8": torch.int8, "bf16": torch.bfloat16, "f32": torch.float32}
DECODE_B = (1, 3, 8)
DECODE_T = (1, 63, 64, 65, 4096, 8193)
DECODE_GROUPS = ((1, 1), (2, 1), (8, 1), (4, 2), (16, 2))   # (Hq, Hkv)


def _lengths(rng, b, t, s):
    """Mixed lengths: fresh (0), at the end (T - s), past it (T), between."""
    picks = [0, t - s, t, max(t - s - 1, 0), int(rng.integers(0, t - s + 1))]
    return np.asarray([picks[i % len(picks)] for i in range(b)], np.int32)


def _cache_case(rng, b, t, h, hd, s, dtype, q_dtype, dev):
    """A cache of ``dtype`` holding random content, its scales, new values
    (some rows louder than their scale, so it grows) and mixed lengths."""
    if dtype == torch.int8:
        cache = torch.from_numpy(rng.integers(-127, 128, (b, t, h, hd),
                                              dtype=np.int8))
        scale = torch.from_numpy(rng.uniform(0.01, 0.05, (b, 1, h, 1))
                                 .astype(np.float32))
    else:
        cache = torch.from_numpy(rng.normal(0, 1, (b, t, h, hd))
                                 .astype(np.float32)).to(dtype)
        scale = None
    loud = rng.choice([0.1, 4.0], (b, 1, h, 1))
    vals = torch.from_numpy((rng.normal(0, 1, (b, s, h, hd)) * loud)
                            .astype(np.float32)).to(q_dtype)
    lens = torch.from_numpy(_lengths(rng, b, t, s))
    return (cache.to(dev), None if scale is None else scale.to(dev),
            vals.to(dev), lens.to(dev))


@pytest.mark.parametrize("hd", [16, 64, 128])
@pytest.mark.parametrize("kind", ["int8", "bf16", "f32"])
def test_kv_cache_write_matches_plain_bit_for_bit(cuda_device, rng, kind, hd):
    from repro_torch.kernels.kv_cache_write import ops as kvw_ops
    from repro_torch.kernels.kv_cache_write.ref import kv_cache_write_ref
    dtype = LM_DTYPES[kind]
    cases = 0
    for b in DECODE_B:
        for t in DECODE_T:
            for h in (1, 2, 8):
                for s in sorted({1, min(3, t), t}):
                    for q_dtype in (torch.bfloat16, torch.float32):
                        cache, scale, vals, lens = _cache_case(
                            rng, b, t, h, hd, s, dtype, q_dtype, cuda_device)
                        for shared in (False, True):
                            ln = lens[:1].reshape(()) if shared else lens
                            c1, c2 = cache.clone(), cache.clone()
                            s1 = None if scale is None else scale.clone()
                            s2 = None if scale is None else scale.clone()
                            n = kvw_ops.kv_cache_write.launches
                            kvw_ops.kv_cache_write(c1, s1, vals, ln)
                            assert (kvw_ops.kv_cache_write.launches == n
                                    + kvw_ops.kernels_a_call(s, hd, dtype))
                            kv_cache_write_ref(c2, s2, vals, ln)
                            torch.cuda.synchronize()
                            assert torch.equal(c1, c2), (b, t, h, s, shared)
                            if scale is not None:
                                assert torch.equal(s1, s2), (b, t, h, s)
                            cases += 1
    assert cases > 100


KV_PIECE_T = (4097, 8193, 32768)


def _piece_lengths(t, s):
    """Eight rows' lengths across the re-projection's pieces: fresh, one
    piece and more, several, half of T, T - s, past T - s, T."""
    return np.asarray([0, 1500, 4100, t // 2 + 7, t - s, min(t - s + 3, t),
                       t, 2049], np.int32)


def _kv_pair_case(rng, t, h, hd, s, dtype, q_dtype, dev):
    """Keys and values of one layer (``_cache_case`` each) at lengths
    ``_piece_lengths``: the int8 scales of the loud rows grow while their
    lengths span several pieces."""
    kc, ks, kx, _ = _cache_case(rng, 8, t, h, hd, s, dtype, q_dtype, dev)
    vc, vs, vx, _ = _cache_case(rng, 8, t, h, hd, s, dtype, q_dtype, dev)
    lens = torch.from_numpy(_piece_lengths(t, s)).to(dev)
    return (kc, ks, kx), (vc, vs, vx), lens


@pytest.mark.parametrize("s", [1, 3, 64])
@pytest.mark.parametrize("t", KV_PIECE_T)
def test_kv_cache_write_kv_over_several_pieces(cuda_device, rng, t, s):
    """Keys and values in one call over caches longer than one piece of the
    re-projection, growing scales, lengths past T - s, per-row and shared
    lengths: bit for bit the plain version applied to keys, then values,
    in ``kernels_a_call`` launches (the decode route at s * hd <= 4,096, the
    prefill route past it)."""
    from repro_torch.kernels.kv_cache_write import ops as kvw_ops
    from repro_torch.kernels.kv_cache_write.ref import kv_cache_write_ref
    h, hd = 2, 128
    for kind, q_dtype in (("int8", torch.bfloat16), ("int8", torch.float32),
                          ("bf16", torch.bfloat16)):
        dtype = LM_DTYPES[kind]
        k, v, lens = _kv_pair_case(rng, t, h, hd, s, dtype, q_dtype,
                                   cuda_device)
        for ln in (lens, lens[3:4].reshape(())):
            got = [x.clone() if x is not None else None
                   for x in (k[0], k[1], v[0], v[1])]
            want = [x.clone() if x is not None else None for x in got]
            n = kvw_ops.kv_cache_write.launches
            kvw_ops.kv_cache_write_kv(got[0], got[1], k[2], got[2], got[3],
                                      v[2], ln)
            assert (kvw_ops.kv_cache_write.launches
                    == n + kvw_ops.kernels_a_call(s, hd, dtype))
            kv_cache_write_ref(want[0], want[1], k[2], ln)
            kv_cache_write_ref(want[2], want[3], v[2], ln)
            torch.cuda.synchronize()
            for g, w in zip(got, want):
                assert g is None or torch.equal(g, w), (kind, t, s, ln.ndim)
            if dtype == torch.int8:
                assert bool((got[1] > k[1]).any()), "no scale grew"


@pytest.mark.parametrize("s", [1, 64])
def test_kv_cache_write_kv_replays_twice_in_a_graph(cuda_device, rng, s):
    """One captured write of a layer's keys and values replayed twice, the
    second time with louder values, so every live block's scale grows
    again: bit for bit the plain version both times (the tickets are put
    back after each launch)."""
    from repro_torch.kernels.kv_cache_write import ops as kvw_ops
    from repro_torch.kernels.kv_cache_write.ref import kv_cache_write_ref
    t, h, hd = 8193, 8, 128
    k, v, lens = _kv_pair_case(rng, t, h, hd, s, torch.int8, torch.bfloat16,
                               cuda_device)
    kx, vx = k[2].clone(), v[2].clone()
    graph_t = [x.clone() for x in (k[0], k[1], v[0], v[1])]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        warm = [x.clone() for x in graph_t]
        kvw_ops.kv_cache_write_kv(warm[0], warm[1], kx, warm[2], warm[3], vx,
                                  lens)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        kvw_ops.kv_cache_write_kv(graph_t[0], graph_t[1], kx, graph_t[2],
                                  graph_t[3], vx, lens)
    for x, y in zip(graph_t, (k[0], k[1], v[0], v[1])):
        x.copy_(y)
    eager = [x.clone() for x in graph_t]
    for loud in (4.0, 16.0):
        kx.copy_((k[2].float() * loud).to(kx.dtype))
        vx.copy_((v[2].float() * loud).to(vx.dtype))
        before = graph_t[1].clone()
        graph.replay()
        kv_cache_write_ref(eager[0], eager[1], kx, lens)
        kv_cache_write_ref(eager[2], eager[3], vx, lens)
        torch.cuda.synchronize()
        for g, w in zip(graph_t, eager):
            assert torch.equal(g, w), loud
        assert bool((graph_t[1] > before).any()), loud


def _bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at |x| (8 significant bits), at least that of 2^-126."""
    e = torch.floor(torch.log2(torch.clamp_min(x.abs(), 2.0 ** -126)))
    return torch.pow(2.0, e - 7)


def bf16_attention_tolerance(q, k, v, ks, vs, off, valid, want):
    """The bf16 contract: one bf16 ulp of the output, plus one bf16 step of
    each probability (2^-8 relative) weighted by |v|. Both versions round
    float32 probabilities to bf16; their float32 sums, taken in other
    orders, move a probability across a rounding boundary now and then."""
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    weight = decode_attention_ref(q, k, v.abs(), ks, vs, off, valid).float()
    return _bf16_ulp(want.abs()) + 2.0 ** -8 * weight


def _check_decode_attention(q, k, v, ks, vs, off, valid) -> float:
    """``decode_attention`` against its plain version under the contract
    (float32 queries 3e-5; bf16 ones ``bf16_attention_tolerance``), one
    launch a call; returns the largest |difference|."""
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    n = da_ops.decode_attention.launches
    got = da_ops.decode_attention(q, k, v, ks, vs, q_offset=off,
                                  kv_valid_len=valid)
    assert da_ops.decode_attention.launches == n + 1
    want = decode_attention_ref(q, k, v, ks, vs, off, valid)
    torch.cuda.synchronize()
    assert got.dtype == q.dtype and got.shape == q.shape
    g, w = got.float(), want.float()
    if q.dtype == torch.float32:     # float32 throughout
        torch.testing.assert_close(g, w, rtol=3e-5, atol=3e-5)
    else:
        tol = bf16_attention_tolerance(q, k, v, ks, vs, off, valid, w)
        bad = (g - w).abs() > tol
        assert not bad.any(), float((g - w).abs().max())
    return float((g - w).abs().max())


@pytest.mark.parametrize("hd", [16, 64, 128])
@pytest.mark.parametrize("kind,q_kind", [("int8", "bf16"), ("int8", "f32"),
                                         ("bf16", "bf16"), ("f32", "f32")])
def test_decode_attention_matches_plain(cuda_device, rng, kind, q_kind, hd):
    dtype, q_dtype = LM_DTYPES[kind], LM_DTYPES[q_kind]
    worst = 0.0
    for b in DECODE_B:
        for t in DECODE_T:
            for hq, hkv in DECODE_GROUPS:
                for s in sorted({1, min(4, t)}):
                    k, ks, _, lens = _cache_case(rng, b, t, hkv, hd, s, dtype,
                                                 q_dtype, cuda_device)
                    v, vs, _, _ = _cache_case(rng, b, t, hkv, hd, s, dtype,
                                              q_dtype, cuda_device)
                    q = torch.from_numpy(rng.normal(0, 1, (b, s, hq, hd))
                                         .astype(np.float32)).to(
                                             cuda_device, q_dtype)
                    off = torch.clamp(lens, max=t - s)
                    try:
                        worst = max(worst, _check_decode_attention(
                            q, k, v, ks, vs, off, off + s))
                    except AssertionError as e:
                        raise AssertionError((b, t, hq, hkv, s)) from e
    assert np.isfinite(worst)


@pytest.mark.parametrize("case", ["edges int8", "edges bf16", "long int8",
                                  "long bf16", "slotted mix"])
def test_decode_attention_at_chunk_edges_and_long_contexts(cuda_device, rng,
                                                           case):
    """The kernel's chunk edges and contexts the grid does not reach, at
    internlm2's heads (16 query, 8 kv heads of 128, group 2, bf16 queries):
    each row's length 1, chunk - 1, chunk, chunk + 1 and T in one call;
    131,072 keys (the long lane's 64 chunks) over int8 and bf16 caches; the
    slotted lane's mix of short and long rows in one call (8 × 32,768)."""
    from repro_torch.kernels.decode_attention import ops as da_ops
    chunk = da_ops._library().decode_attention_chunk()
    kind = case.split()[-1] if case != "slotted mix" else "int8"
    dtype = LM_DTYPES[kind]
    if case.startswith("edges"):
        t = 3 * chunk + 5
        lens = [1, chunk - 1, chunk, chunk + 1, t]
    elif case.startswith("long"):
        t = 131_072
        lens = [t, t - 1 - int(rng.integers(0, chunk))]
    else:
        t = 32_768
        lens = [int(x) for x in rng.integers(16, 161, 6)] + [t, t - 3]
    b = len(lens)
    k, ks, _, _ = _cache_case(rng, b, t, 8, 128, 1, dtype, torch.bfloat16,
                              cuda_device)
    v, vs, _, _ = _cache_case(rng, b, t, 8, 128, 1, dtype, torch.bfloat16,
                              cuda_device)
    q = torch.from_numpy(rng.normal(0, 1, (b, 1, 16, 128))
                         .astype(np.float32)).to(cuda_device, torch.bfloat16)
    valid = torch.tensor(lens, dtype=torch.int32, device=cuda_device)
    assert np.isfinite(_check_decode_attention(q, k, v, ks, vs, valid - 1,
                                               valid))


def test_decode_kernels_replay_in_a_graph_at_any_length(cuda_device, rng):
    """Lengths are read on the device: one captured write-and-attend serves
    every length, as the eager calls do."""
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.kv_cache_write.ops import kv_cache_write
    b, t, hq, hkv, hd = 3, 1000, 8, 2, 128
    cache, scale, vals, _ = _cache_case(rng, b, t, hkv, hd, 1, torch.int8,
                                        torch.bfloat16, cuda_device)
    q = torch.randn((b, 1, hq, hd), device=cuda_device).to(torch.bfloat16)
    lens = torch.zeros((b,), dtype=torch.int32, device=cuda_device)

    def step(c, sc):
        kv_cache_write(c, sc, vals, lens)
        return decode_attention(q, c, c, sc, sc, q_offset=lens,
                                kv_valid_len=lens + 1)

    gc_, gs = cache.clone(), scale.clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step(gc_.clone(), gs.clone())
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = step(gc_, gs)
    ec, es = cache.clone(), scale.clone()
    gc_.copy_(cache)
    gs.copy_(scale)
    for n in (0, 5, 999, 1000, 17):
        lens.fill_(n)
        graph.replay()
        want = step(ec, es)
        torch.cuda.synchronize()
        assert torch.equal(out, want) and torch.equal(gc_, ec), n
        assert torch.equal(gs, es)


def test_decode_cells_replay_in_place_and_match_the_cpu_engine(cuda_device,
                                                               rng):
    """The LM's decode cells on the card: the slotted lane generates the CPU
    engine's tokens; the classic cell's caches are its graph's static
    inputs, returned by ``Engine.decode`` and read back without a copy."""
    from repro_torch.configs.internlm2_1_8b import make_config as lm_config
    from repro_torch.models.lm import LM
    from repro_torch.serve import lm_decode_cell, lm_decode_slotted_cell
    cfg = lm_config(reduced=True)
    params, buffers = LM.init(torch.Generator().manual_seed(0), cfg)
    prompts = [rng.integers(0, cfg.vocab, int(n)).astype(np.int32)
               for n in rng.integers(2, 9, 7)]
    tokens = {}
    for dev in ("cpu", cuda_device):
        engine = Engine(device=dev)
        p, b = tree_map(lambda x: x.to(dev), (params, buffers))
        engine.register(lm_decode_slotted_cell(cfg, p, b, batch=3,
                                               max_len=32, arch="lm"))
        tickets = [engine.submit_decode(x, 4) for x in prompts]
        engine.drain()
        tokens[str(dev)] = [engine.poll(t) for t in tickets]
    for a, c in zip(tokens["cpu"], tokens[str(cuda_device)]):
        np.testing.assert_array_equal(a, c)

    engine = Engine(device=cuda_device)
    p, b = tree_map(lambda x: x.to(cuda_device), (params, buffers))
    reg = engine.register(lm_decode_cell(cfg, p, b, batch=2, max_len=16,
                                         arch="lm"))
    static = reg.cell.inputs[1]
    assert reg.cell.captured == {"kv_cache_write": cfg.n_layers,
                                 "decode_attention": cfg.n_layers}
    assert not static["k"].any() and int(static["len"]) == 0
    caches = engine.fresh_caches()
    toks = np.asarray([[3], [5]], np.int32)
    logits, out = engine.decode(toks, caches)
    assert all(out[k] is static[k] for k in static if k != "len")
    assert not caches["k"].any()          # the caller's copy is not written
    logits2, out2 = engine.decode(toks, out)
    assert all(out2[k] is static[k] for k in static if k != "len")
    assert int(out2["len"]) == 2 and logits.shape == (2, cfg.vocab)
    assert reg.cell.replays == 2


# -- the LM's training path ----------------------------------------------------

@pytest.mark.parametrize("d", [257, 512, 1000, 2048, 6144])
def test_qat_kernels_match_plain_on_wide_rows(cuda_device, rng, d):
    """Rows wider than a warp's 256 lanes take a block a row: out and drows
    bit-identical to the plain version, the sums (float64) at rtol 1e-4 /
    atol 1e-6, the backward twice bit-identical; misaligned rows (the
    scalar route) too."""
    for bits in [(0, 1, 2, 3, 4, 5, 6), (3,), tuple(range(16))]:
        for t in (1, 255, 256, 4097):
            rows, probs, alpha, beta, g = _qat_inputs(rng, t, d, bits,
                                                      cuda_device)
            if t == 255:     # one float past a 16-byte boundary
                rows = torch.cat([rows.new_zeros(1), rows.reshape(-1)])[1:] \
                    .reshape(t, d)
            out = qat_ops.mixed_expectation_fwd(rows, probs, alpha, beta, bits)
            got = qat_ops.mixed_expectation_bwd(rows, probs, alpha, beta, g,
                                                bits)
            again = qat_ops.mixed_expectation_bwd(rows, probs, alpha, beta, g,
                                                  bits)
            torch.cuda.synchronize()
            want_out = mixed_expectation_fwd_ref(rows, probs, alpha, beta,
                                                 bits)
            want = mixed_expectation_bwd_ref(rows, probs, alpha, beta, g,
                                             bits, sum_dtype=torch.float64)
            assert torch.equal(out, want_out)
            assert torch.equal(got[0], want[0])
            for x, w, y in zip(got[1:], want[1:], again[1:]):
                torch.testing.assert_close(x, w, rtol=1e-4, atol=1e-6)
                assert torch.equal(x, y)


@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
def test_adam_pass_on_bf16_leaves_matches_the_plain_chain(cuda_device, rng,
                                                          weight_decay):
    """bf16 leaves and gradients with float32 moments: the pass bit for bit
    the plain chain's, with a constant rate and a schedule's, decayed
    (matrices) and not (vectors); a skipped step keeps every bit; a bf16
    leaf with bf16 moments is refused."""
    hyper = dict(b1=0.9, b2=0.999, eps=1e-8, weight_decay=weight_decay)
    bc1 = torch.full((), 0.1, device=cuda_device)
    bc2 = torch.full((), 0.001, device=cuda_device)
    scale = torch.full((), 0.37, device=cuda_device)
    for lr in (1e-3, torch.full((), 7.25e-4, device=cuda_device)):
        for shape in [(1,), (7,), (4099,), (1000, 33), (4096, 8)]:
            p, g = (torch.from_numpy(rng.normal(0, s, shape).astype(
                np.float32)).to(cuda_device, torch.bfloat16)
                for s in (1.0, 3e-2))
            m = torch.from_numpy(rng.normal(0, 1e-3, shape).astype(
                np.float32)).to(cuda_device)
            v = torch.from_numpy(rng.uniform(0, 1e-4, shape).astype(
                np.float32)).to(cuda_device)
            for ok in (True, False):
                ok_t = torch.full((), ok, device=cuda_device)
                got = [x.clone() for x in (p, m, v)]
                want = [x.clone() for x in (p, m, v)]
                before = adam_ops.adam_step_.launches
                adam_ops.adam_step_(got[0], g, got[1], got[2], scale, ok_t,
                                    bc1, bc2, lr=lr, **hyper)
                assert adam_ops.adam_step_.launches == before + 1
                adam_step_ref_(want[0], g, want[1], want[2], scale, ok_t, bc1,
                               bc2, lr=lr, **hyper)
                for x, y in zip(got, want):
                    assert torch.equal(x, y)
                # a taken step moves the moments (a bf16 leaf may round back
                # to its value); a skipped one keeps every bit
                assert torch.equal(got[1], m) != ok
                if not ok:
                    assert all(torch.equal(x, x0)
                               for x, x0 in zip(got, (p, m, v)))
    with pytest.raises(TypeError, match="float32 moments"):
        adam_ops.adam_step_(p, g, m.bfloat16(), v.bfloat16(), scale, ok_t,
                            bc1, bc2, lr=1e-3, **hyper)


def _lm_trainer(arch, device, dtype="float32", seq=256):
    """A reduced LM (``ce_chunk`` 64) from one seed on the CPU, carried to
    ``device``, with its Trainer (``adam(1e-3)``) and three TokenStream
    batches of 2 x ``seq``."""
    cfg = get_arch(arch).make_config(reduced=True)._replace(
        ce_chunk=64, dtype=dtype)
    params, buffers = LM.init(torch.Generator().manual_seed(0), cfg)
    params = tree_map(lambda x: x.to(device), params)
    buffers = tree_map(lambda x: x.to(device) if torch.is_tensor(x) else x,
                       buffers)

    def loss_fn(p, bu, st, batch, *, step=None):
        loss, ce = LM.loss_fn(p, bu, batch, cfg, train=True, step=step)
        return loss, (st, ce)

    stream = TokenStream(cfg.vocab, 2, seq)
    return cfg, Trainer(loss_fn, params, buffers, {}, adam(1e-3)), stream


@pytest.mark.parametrize("arch,dtype,rtol", [
    ("internlm2-1.8b", "float32", 1e-4), ("internlm2-1.8b", "bfloat16", 2e-2),
    ("deepseek-moe-16b", "float32", 1e-4)])
def test_reduced_lm_trainer_steps_match_the_cpu(cuda_device, arch, dtype,
                                                rtol):
    """Three steps of a reduced LM (S = 256: the tiled flash route; the
    MoE's dispatch and combine on the segment sum in both directions) on
    the card against the same steps on the CPU: losses within ``rtol``
    (float32: the flash kernels' split TF32 and the products' sum order;
    bf16: the card's bf16 products round elsewhere than the CPU's); each
    step launches the flash forward with its statistics
    twice a layer (remat), the backward once a layer and the Adam pass
    once a leaf."""
    runs = {}
    for dev in ("cpu", cuda_device):
        cfg, tr, stream = _lm_trainer(arch, dev, dtype)
        if dev != "cpu":
            counts0 = (flash_ops.flash_attention_fwd_stats.launches,
                       flash_ops.flash_attention_bwd.launches,
                       adam_ops.adam_step_.launches)
        tr.run(stream.batch_at, 3, log_every=0)
        runs[str(dev)] = [h["loss"] for h in tr.history]
        assert not any(h["skipped"] for h in tr.history)
    counts = (flash_ops.flash_attention_fwd_stats.launches - counts0[0],
              flash_ops.flash_attention_bwd.launches - counts0[1],
              adam_ops.adam_step_.launches - counts0[2])
    n_leaves = len(leaves(tr.params))
    assert counts == (3 * 2 * cfg.n_layers, 3 * cfg.n_layers, 3 * n_leaves)
    if dtype == "bfloat16":
        assert all(m.dtype == torch.float32
                   for m in leaves(tr.carry["opt"]["mu"]))
    np.testing.assert_allclose(runs[str(cuda_device)], runs["cpu"], rtol=rtol)


def _loss_grads(tr, batch):
    """The gradient of ``tr``'s loss in each of its parameters, as float32
    on the CPU."""
    flat = [p.detach().requires_grad_(True) for p in leaves(tr.params)]
    loss, _ = tr.loss_fn(unflatten(tr.params, flat), tr.buffers, {}, batch)
    return [g.float().cpu() for g in torch.autograd.grad(loss, flat)]


def test_moe_training_step_runs_no_library_scatter_add(cuda_device):
    """A reduced deepseek-moe-16b's loss and backward: each gradient leaf
    on the card within 1e-4 of its largest |value| of the same gradient on
    the CPU (the split-TF32 flash kernels and the products' sum order);
    then a training step under the profiler, where the dispatch's and the
    combine's gathers sum their gradients on the segment-sum kernel and no
    library scatter-add runs."""
    grads = {}
    for dev in ("cpu", cuda_device):
        cfg, tr, stream = _lm_trainer("deepseek-moe-16b", dev, seq=128)
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in stream.batch_at(0).items()}
        grads[str(dev)] = _loss_grads(tr, batch)
    for got, want in zip(grads[str(cuda_device)], grads["cpu"]):
        top = max(float(want.abs().max()), 1e-30)
        assert float((got - want).abs().max()) <= 1e-4 * top
    before = seg_ops.segment_sum.launches
    names = _kernel_names(lambda: tr.train_step(batch, 0))
    # each layer: the combine's forward scatter, both gathers' backward
    assert seg_ops.segment_sum.launches - before >= 3 * cfg.n_layers
    assert any("segment" in n for n in names)
    assert [n for n in names if seg_ops.is_library_scatter_add(n)] == []


def test_span_event_pair_times_the_device(cuda_device):
    """A span given the card times its work by a pair of CUDA events, which
    ``records()`` resolves to device milliseconds: at least the kernels it
    enclosed, at most its host interval (the events' own records aside)
    once the host waited for them; a span without a device carries its
    host milliseconds. No device event carries a span's name unless it is
    flagged as a user annotation (the benchmark's trace drops those from
    the device's work). A profile with no device activity is taken
    again."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import spans
    a = torch.randn(4096, 4096, device=cuda_device)
    (a @ a).sum().item()
    cuda = torch.autograd.DeviceType.CUDA
    for _ in range(3):
        spans.clear()
        try:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                with spans.span("train.forward", device=cuda_device):
                    for _ in range(4):
                        b = a @ a
                    with spans.span("serve.readback"):
                        b.cpu()
            step, readback = spans.records()
        finally:
            spans.clear()
        dev = [e for e in prof.events() if e.device_type == cuda]
        if dev:
            break
    gemm_ms = sum(e.time_range.elapsed_us() for e in dev
                  if "gemm" in e.name.lower()) / 1e3
    assert gemm_ms > 0
    assert 0.95 * gemm_ms <= step.ms <= step.host_ms + 1.0
    assert step._events is None          # resolved once, then freed
    assert readback.parent is step and readback.ms == readback.host_ms
    names = ("train.forward", "serve.readback")
    assert [e.name for e in dev if e.name in names
            and not getattr(e, "is_user_annotation", False)] == []
