"""The port on the card: the CUDA ``mpe_lookup`` and ``mpe_qat`` kernels
against their plain PyTorch versions, their wrappers' checks and launch
counts, the backward's repeatability, the engine on the card against the
engine on the CPU, and a training run that goes through the kernels.

Every test here needs a CUDA card and the CUDA toolkit; the ``cuda_device``
fixture skips them elsewhere. The file imports no JAX, so it runs on a
machine that has only the port's dependencies:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch.configs.dlrm_criteo import make_config
from repro_torch.core.inference import build_packed_table
from repro_torch.core.mpe import MPEConfig
from repro_torch.data.synthetic import CTRSpec, SyntheticCTR
from repro_torch.kernels.mpe_lookup import ops
from repro_torch.kernels.mpe_lookup.ref import packed_lookup_ref
from repro_torch.kernels.mpe_qat import ops as qat_ops
from repro_torch.kernels.mpe_qat.ref import (mixed_expectation_bwd_ref,
                                             mixed_expectation_fwd_ref)
from repro_torch.launch import train as launch_train
from repro_torch.launch.serve import build_engine
from repro_torch.models.dlrm import DLRM

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
    before = ops.packed_lookup.launches
    got = card.score(ids, return_logits=True)
    assert ops.packed_lookup.launches > before
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
    dprobs, dalpha, dbeta, summed in another order, at rtol 1e-4 / atol 1e-6."""
    grid = [(0, 1, 2, 3, 4, 5, 6)] + [(0, b) for b in range(1, 9)]
    for bits in grid:
        for d in (8, 16, 50, 64):
            for t in (1, 255, 257, 4099):
                rows, probs, alpha, beta, g = _qat_inputs(
                    rng, t, d, bits, cuda_device, onehot)
                out = qat_ops.mixed_expectation_fwd(rows, probs, alpha, beta, bits)
                got = qat_ops.mixed_expectation_bwd(rows, probs, alpha, beta, g,
                                                    bits)
                torch.cuda.synchronize()
                want_out = mixed_expectation_fwd_ref(rows, probs, alpha, beta, bits)
                want = mixed_expectation_bwd_ref(rows, probs, alpha, beta, g, bits)
                torch.testing.assert_close(out, want_out, rtol=0, atol=0)
                torch.testing.assert_close(got[0], want[0], rtol=0, atol=0)
                for x, w in zip(got[1:], want[1:]):
                    torch.testing.assert_close(x, w, rtol=1e-4, atol=1e-6)


def test_qat_backward_is_repeatable(cuda_device, rng):
    bits = (0, 1, 2, 3, 4, 5, 6)
    rows, probs, alpha, beta, g = _qat_inputs(rng, 100_003, 16, bits, cuda_device)
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
