"""Port parity for the serving path: the engine scores a reference packed
DLRM exactly as the port's forward of each planned chunk, zero-padded to its
cell and sliced back; within a few float32 ulps of the port's unbatched
forward (the CPU's BLAS picks its kernel by row count) and within rtol 1e-4
/ atol 1e-4 of the reference's; the batcher plans and packs like the
reference's; entry points need a device."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.synthetic import CTRSpec as JCTRSpec
from repro.data.synthetic import SyntheticCTR as JSyntheticCTR
from repro.models.dlrm import DLRM as JDLRM
from repro.serve.batcher import RequestBatcher as JRequestBatcher
from repro.serve.stats import LatencyStats as JLatencyStats
from repro_torch.data.synthetic import CTRSpec, SyntheticCTR
from repro_torch.interop import model_from_numpy
from repro_torch.kernels.mpe_lookup import ops
from repro_torch.launch import serve as launch_serve
from repro_torch.launch.serve import build_engine
from repro_torch.models.dlrm import DLRM
from repro_torch.serve.batcher import RequestBatcher
from repro_torch.serve.engine import Engine
from repro_torch.serve.stats import LatencyStats
from test_torch_dlrm import make_reference_dlrm

VOCABS = (600, 400, 500)
# the same rows in a block of another row count: at most eight float32 ulps
# of a logit (2**-23 ~ 1.2e-7 relative), and as much at the logits' scale
# (~0.1) for one near zero
ULPS = dict(rtol=1e-6, atol=1e-7)


@pytest.fixture(scope="module")
def served():
    """A reference packed DLRM behind a CPU engine with 64/256-row cells."""
    jcfg, cfg, params, state, buffers = make_reference_dlrm(
        "dnn", seed=3, vocabs=VOCABS)
    t_params, t_state, t_buffers = model_from_numpy(params, state, buffers,
                                                    cfg, "cpu")
    engine = build_engine(cfg, t_params, t_state, t_buffers,
                          p99_rows=64, bulk_rows=256, device="cpu")
    return {"engine": engine, "jcfg": jcfg, "cfg": cfg,
            "ref": (params, state, buffers),
            "port": (t_params, t_state, t_buffers),
            "spec": CTRSpec(field_vocabs=VOCABS, seed=3)}


def _requests(served, n, step=777):
    return SyntheticCTR(served["spec"]._replace(batch_size=n)).batch(step)["ids"]


def _port_unbatched(served, ids):
    params, state, buffers = served["port"]
    return DLRM.apply(params, buffers, state, {"ids": torch.from_numpy(ids)},
                      served["cfg"])[0].numpy()


def _port_padded(served, ids):
    """The port's forward of each chunk the engine's batcher plans, padded
    with ``RequestBatcher.pad``'s zeros and sliced back with ``unpad``."""
    batcher = RequestBatcher(served["engine"].registered_shapes)
    return np.concatenate([
        batcher.unpad(_port_unbatched(served, batcher.pad(
            ids[c.start:c.start + c.n_valid], c.rows)[0]), c.n_valid)
        for c in batcher.plan(len(ids))])


def _reference_unbatched(served, ids):
    params, state, buffers = served["ref"]
    logits, _, _ = JDLRM.apply(params, buffers, state,
                               {"ids": jnp.asarray(ids)}, served["jcfg"],
                               train=False)
    return np.asarray(logits)


@pytest.mark.parametrize("n", [1, 50, 300, 600])
def test_score_matches_unbatched_forwards(served, n):
    ids = _requests(served, n)
    got = served["engine"].score(ids, return_logits=True)
    assert got.shape == (n,)
    np.testing.assert_array_equal(got, _port_padded(served, ids))
    np.testing.assert_allclose(got, _port_unbatched(served, ids), **ULPS)
    np.testing.assert_allclose(got, _reference_unbatched(served, ids),
                               rtol=1e-4, atol=1e-4)


def test_score_probabilities_and_counters(served):
    engine = Engine(device="cpu")
    params, state, buffers = served["port"]
    engine.register_packed_model("dlrm", DLRM, served["cfg"], params, state,
                                 buffers, shapes={"serve_p99": 64,
                                                  "serve_bulk": 256})
    probs = engine.score(_requests(served, 10, 778))
    assert probs.shape == (10,) and ((probs > 0) & (probs < 1)).all()
    engine.score(_requests(served, 300, 779))     # 256 + 44 rows
    c = engine.counters()
    assert c["goodput"]["by_lane"] == {"score:p0": 2}
    assert c["occupancy"]["dlrm/serve_p99"]["valid_rows"] == 10 + 44
    assert c["occupancy"]["dlrm/serve_bulk"]["padded_rows"] == 256
    s = engine.stats.summary()["dlrm/serve_p99"]
    assert s["count"] == 2 and "lookup_p50_ms" in s and "compute_p50_ms" in s


def test_engine_on_cpu_launches_no_kernel(served):
    before = ops.packed_lookup.launches
    served["engine"].score(_requests(served, 20, 780))
    assert ops.packed_lookup.launches == before


@pytest.mark.parametrize("n", [1, 300, 512, 513, 5000, 300_000])
def test_batcher_plan_equals_reference(n):
    shapes = {"serve_p99": 512, "serve_bulk": 2048}
    got = [tuple(c) for c in RequestBatcher(shapes).plan(n)]
    want = [tuple(c) for c in JRequestBatcher(shapes).plan(n)]
    assert got == want


@pytest.mark.parametrize("sizes", [[1], [300, 300], [5, 600, 2, 1500, 40],
                                   [2048, 1, 4097]])
def test_batcher_pack_equals_reference(sizes):
    shapes = {"serve_p99": 512, "serve_bulk": 2048}
    got = RequestBatcher(shapes).pack(sizes)
    want = JRequestBatcher(shapes).pack(sizes)
    assert [(c.bucket, c.rows, c.start, c.n_valid, tuple(map(tuple, c.spans)))
            for c in got] == \
        [(c.bucket, c.rows, c.start, c.n_valid, tuple(map(tuple, c.spans)))
         for c in want]


def test_batcher_pad_equals_reference(rng):
    arr = rng.integers(0, 100, (37, 3)).astype(np.int32)
    padded, mask = RequestBatcher.pad(arr, 64)
    jpadded, jmask = JRequestBatcher.pad(arr, 64)
    np.testing.assert_array_equal(padded, jpadded)
    np.testing.assert_array_equal(mask, jmask)


def test_latency_stats_match_reference(rng):
    stats, jstats = LatencyStats(), JLatencyStats()
    for i in range(20):
        rec = (float(rng.uniform(1, 9)), float(rng.uniform(0.1, 1)))
        for s in (stats, jstats):
            s.record("a/serve_p99", *rec, valid_rows=i + 1, capacity_rows=64)
    assert stats.summary(skip_warmup=3) == jstats.summary(skip_warmup=3)
    assert stats.occupancy() == jstats.occupancy()
    assert stats.format_table() == jstats.format_table()


def test_synthetic_stream_equals_reference():
    spec = dict(field_vocabs=(900, 50, 3000), batch_size=128, seed=5)
    ds, jds = SyntheticCTR(CTRSpec(**spec)), JSyntheticCTR(JCTRSpec(**spec))
    np.testing.assert_array_equal(ds.expected_frequencies(),
                                  jds.expected_frequencies())
    for step in (0, 7, 10_000):
        a, b = ds.batch(step), jds.batch(step)
        np.testing.assert_array_equal(a["ids"], b["ids"])
        np.testing.assert_array_equal(a["label"], b["label"])


def test_entry_points_raise_without_device(served, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    params, state, buffers = served["port"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_engine(served["cfg"], params, state, buffers)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_serve.main(["--reduced", "--requests", "1"])


def test_serve_cli_on_cpu(tmp_path, capsys):
    out = tmp_path / "serve.json"
    engine = launch_serve.main(["--reduced", "--device", "cpu", "--requests",
                                "3", "--batch", "40", "--bulk", "700",
                                "--p99-rows", "64", "--bulk-rows", "512",
                                "--json", str(out)])
    assert engine.counters()["goodput"]["by_lane"] == {"score:p0": 4}
    assert "dlrm/serve_p99" in capsys.readouterr().out
    assert out.exists()
