"""The port's launchers on the CPU:

- ``launch.train`` at the reduced config for every compressor of the
  reference's launcher (``mpe plain lsq alpt qr pep optfs``) and for
  ``--arch wide-deep``: finite losses, no step skipped, the reference's
  storage ratios, ALPT's table on its grid after training, ``--prefetch``
  bit-identical to the synchronous run;
- ``--ckpt-dir`` resumes: 4 steps, then the launcher again to 6 from the
  checkpoint, against 6 steps in one run, bit for bit (the MPE pipeline
  resumes each phase from its own directory);
- ``launch.serve --train-steps`` serves what the pipeline trained (the
  reference's ``train_packed_dlrm``).
"""
import numpy as np
import pytest
import torch

from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.train.tree import leaves

BASE = ["--reduced", "--device", "cpu", "--batch", "128"]
RATIOS = {"plain": 1.0, "lsq": 6 / 32, "alpt": 8 / 32}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Parallel test workers share the machine's cores: torch's intra-op
    thread pool in each would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch", ["dlrm-criteo", "wide-deep"])
@pytest.mark.parametrize("compressor", ["plain", "lsq", "alpt", "qr", "pep",
                                        "optfs"])
def test_every_baseline_trains(arch, compressor, capsys):
    res = launch_train.main([*BASE, "--arch", arch, "--steps", "3",
                             "--compressor", compressor])
    assert f"[train] {compressor} ratio=" in capsys.readouterr().out
    hist = res["history"]
    assert len(hist) == 3 and all(np.isfinite(h["loss"]) for h in hist)
    assert not any(h["skipped"] for h in hist)
    assert 0.0 < res["storage_ratio"] <= 1.0 and "auc" in res["eval"]
    if compressor in RATIOS:
        assert res["storage_ratio"] == RATIOS[compressor]
    if compressor == "qr":
        assert 0.5 < res["storage_ratio"] < 0.51
    if compressor == "alpt":
        emb, alpha = res["params"]["embedding"]["emb"], res["params"]["embedding"]["alpha"]
        codes = torch.round(emb / alpha)
        assert torch.equal(alpha * codes, emb)
        assert codes.min() >= -128 and codes.max() <= 127
    if compressor == "optfs":
        assert res["comp_cfg"] == {"total_steps": 3}


@pytest.mark.parametrize("compressor", ["mpe", "lsq"])
def test_prefetch_flag_is_loss_identical(compressor):
    argv = [*BASE, "--steps", "3", "--retrain-steps", "2", "--compressor",
            compressor]
    sync, pre = launch_train.main(argv), launch_train.main([*argv, "--prefetch"])
    if compressor == "mpe":
        for key in ("search_history", "retrain_history"):
            assert [h["loss"] for h in sync[key]] == [h["loss"] for h in pre[key]]
    else:
        assert [h["loss"] for h in sync["history"]] == [h["loss"] for h in pre["history"]]


def test_ckpt_dir_resumes_bit_exactly(tmp_path):
    argv = [*BASE, "--compressor", "pep"]
    launch_train.main([*argv, "--steps", "4", "--ckpt-dir", str(tmp_path)])
    resumed = launch_train.main([*argv, "--steps", "6", "--ckpt-dir", str(tmp_path)])
    whole = launch_train.main([*argv, "--steps", "6"])
    assert resumed["start_step"] == 4 and len(resumed["history"]) == 2
    assert [h["loss"] for h in resumed["history"]] == [
        h["loss"] for h in whole["history"][4:]]
    for a, b in zip(leaves(resumed["params"]), leaves(whole["params"])):
        assert torch.equal(a, b)


def test_pipeline_ckpt_dir_resumes_each_phase(tmp_path):
    argv = [*BASE, "--arch", "wide-deep", "--steps", "3", "--retrain-steps", "2"]
    first = launch_train.main([*argv, "--ckpt-dir", str(tmp_path)])
    assert sorted(p.name for p in tmp_path.iterdir()) == ["retrain", "search"]
    again = launch_train.main([*argv, "--ckpt-dir", str(tmp_path)])
    # both phases restored at their last step: nothing left to run
    assert again["search_history"] == [] and again["retrain_history"] == []
    for a, b in zip(leaves(first["final_params"]), leaves(again["final_params"])):
        assert torch.equal(a, b)


def test_serve_with_train_steps(capsys):
    engine = launch_serve.main(["--reduced", "--device", "cpu", "--requests",
                                "3", "--batch", "100", "--train-steps", "3"])
    out = capsys.readouterr().out
    assert "packed ratio=" in out and "serve_p99" in out
    assert engine.counters()["goodput"]["by_lane"] == {"score:p0": 3}


def test_train_packed_dlrm_serves_its_pipeline():
    cfg, params, state, buffers, spec, res = launch_serve.train_packed_dlrm(
        train_steps=2, train_batch=256, device="cpu")
    assert cfg.compressor == "packed" and params["embedding"] is res["packed_table"]
    assert cfg.comp_cfg["n"] == sum(spec.field_vocabs)
    assert len(res["search_history"]) == len(res["retrain_history"]) == 2
    assert buffers["embedding"]["meta"] == res["packed_meta"]
