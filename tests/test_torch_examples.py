"""The examples' twins on the PyTorch port: each one's ``main`` runs to its
end on the CPU at a couple of steps (``--device cpu``) and returns what it
printed from. Each twin imports only ``repro_torch``
(``tests/test_torch_isolation.py`` holds them to that)."""
import importlib.util
import math
from pathlib import Path

import pytest
import torch

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Parallel test workers share the machine's cores: one torch thread
    each keeps the small ops from oversubscribing them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def load(name):
    spec = importlib.util.spec_from_file_location(name, EXAMPLES / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_quickstart_twin(capsys):
    res = load("quickstart_torch").main(["--steps", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "served batch from packed table: (2048,) logits" in out
    assert 0.0 < res["storage_ratio"] <= 1.0
    assert len(res["search_history"]) == len(res["retrain_history"]) == 2
    assert 0.0 <= res["eval"]["auc"] <= 1.0


def test_serve_packed_twin(capsys):
    engine = load("serve_packed_torch").main(
        ["--train-steps", "2", "--requests", "3", "--bulk", "5000",
         "--device", "cpu"])
    assert engine.device.type == "cpu"
    assert engine.registered_shapes == {"serve_p99": 512, "serve_bulk": 4096}
    summary = engine.summary()
    assert summary["dlrm/serve_p99"]["count"] >= 3
    assert summary["dlrm/serve_bulk"]["count"] >= 1
    assert "serve_p99" in capsys.readouterr().out


def test_train_ctr_end_to_end_twin(tmp_path, capsys, monkeypatch):
    twin = load("train_ctr_end_to_end_torch")
    # the twin's own fields at a thousandth of their vocabularies
    monkeypatch.setattr(twin, "VOCABS", tuple(v // 1024 for v in twin.VOCABS))
    res = twin.main(["--steps", "2", "--batch", "256",
                     "--ckpt-dir", str(tmp_path), "--device", "cpu"])
    out = capsys.readouterr().out
    assert "model size:" in out and "checkpoints in" in out
    assert (tmp_path / "search").is_dir() and (tmp_path / "retrain").is_dir()
    assert all(math.isfinite(h["loss"]) for h in res["retrain_history"])
    assert res["packed_meta"]["n"] == sum(twin.VOCABS)


def test_gnn_molecule_twin(capsys):
    tr, bits = load("gnn_molecule_mpe_torch").main(
        ["--steps", "2", "--device", "cpu"])
    assert len(tr.history) == 2
    assert all(math.isfinite(h["loss"]) for h in tr.history)
    assert 0.0 <= bits <= 6.0
    assert "atom-table avg bits" in capsys.readouterr().out


def test_lm_vocab_mpe_twin(capsys):
    tr, bits = load("lm_vocab_mpe_torch").main(
        ["--steps", "3", "--device", "cpu"])
    assert len(tr.history) == 3
    assert all(math.isfinite(h["loss"]) and not h["skipped"]
               for h in tr.history)
    assert 0.0 <= bits <= 6.0
    out = capsys.readouterr().out
    assert "vocab-table avg bits" in out and "rare-quartile" in out
