"""The port's MPE pipeline (search → Eq. 11 sampling → retrain → packed
export) on the CPU:

- from one carried search-phase init with γ drawn at random (0.01·N(0, 1),
  as the packed compressor's init draws it), the port's and the
  reference's pipelines, a few steps each, sample the same widths for
  every group and feature; the port's export of the reference's final
  parameters is byte-identical to the reference's table, and the two
  packages' own tables agree in all but at most 0.1% of their codes, each
  of those one step apart. Adam divides a gradient by its own magnitude
  plus 1e-8, so where a gradient is of rounding size the two packages take
  different steps: after four retrain steps one of 25,600 weights differs
  by 3e-6 and its code by one step;
- from the default init, γ = 0, the two pipelines sample the same width
  for at least 90% of the groups, and the reference does no better against
  itself: every group's p is uniform there, so the Eq. 10 gradient of the
  width whose bits equal the mean width is a rounding residue, whose sign
  Adam's normalisation turns into steps of the full learning rate once p
  has moved. Run from a γ that moves half of p's entries by one or two
  float32 steps (γ = 1e-10·N(0, 1)), the reference samples another width for some
  groups, and for about as many as the port does;
- on the port alone, the six assertions of ``tests/test_system.py`` at its
  spec (4 fields, batch 1024, MLP (32, 16), 80 search + 80 retrain steps):
  ratio < 6/32, average bits < 6, AUC > 0.70, frequent groups get at least
  the bits of rare ones, the export serves what ``MPERetrainEmbedding``
  looks up (atol 1e-6), packed bytes follow the ratio, and the ``none``
  retrain mode is evaluable;
- the training launcher's CLI on the CPU.
"""
import jax
import numpy as np
import pytest
import torch

from repro.core.mpe import MPEConfig as JMPEConfig
from repro.core.pipeline import run_mpe_pipeline as j_run_mpe_pipeline
from repro.data.synthetic import CTRSpec as JCTRSpec
from repro.data.synthetic import SyntheticCTR as JSyntheticCTR
from repro.train.optimizer import adam as jadam
from repro.zoo import dlrm_builder as j_dlrm_builder
from repro_torch.core.inference import build_packed_table, packed_lookup
from repro_torch.core.packing import unpack_codes
from repro_torch.core.mpe import MPEConfig
from repro_torch.core.pipeline import run_mpe_pipeline
from repro_torch.core.sampling import MPERetrainEmbedding
from repro_torch.data.synthetic import CTRSpec, SyntheticCTR
from repro_torch.embeddings.table import FieldSpec
from repro_torch.interop import model_from_numpy
from repro_torch.launch import train as launch_train
from repro_torch.models.dlrm import DLRMConfig
from repro_torch.train.optimizer import adam
from repro_torch.zoo import dlrm_builder
from test_torch_train import configs, np_tree

LAM = 3e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Parallel test workers share the machine's cores: torch's intra-op
    thread pool in each would oversubscribe them, and its spinning threads
    then slow these many small ops a hundredfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def assert_same_table(got, want):
    """A port packed table against a reference one, bit for bit."""
    assert set(got["subtables"]) == set(want["subtables"])
    for k, words in want["subtables"].items():
        np.testing.assert_array_equal(
            got["subtables"][k].numpy().view(np.uint32), np.asarray(words))
    for k in ("local_idx", "width_idx", "alpha", "beta"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


class _CarriedPipelines:
    """The reference's and the port's pipelines (6 search + 4 retrain
    steps) on one data stream, each starting its search phase from one
    reference init whose γ is given."""

    vocabs = (700, 400, 300, 200)
    kw = dict(search_steps=6, retrain_steps=4, retrain_mode="mpe",
              log_fn=lambda *a: None)

    def __init__(self):
        self.spec = JCTRSpec(field_vocabs=self.vocabs, batch_size=256, seed=4)
        self.jds = JSyntheticCTR(self.spec)
        freqs = self.jds.expected_frequencies()
        jcfg, self.cfg = configs("mpe_search", None, self.vocabs)
        self.jbuild = j_dlrm_builder(jcfg, freqs, lam=LAM)
        self.jmpe = JMPEConfig(group_size=16, lam=LAM)
        self.init = self.jbuild(jax.random.PRNGKey(4), "mpe_search",
                                self.jmpe._asdict())
        self.port_build = dlrm_builder(self.cfg, freqs, lam=LAM, device="cpu")

    def params(self, gamma):
        params = np_tree(self.init["params"])
        params["embedding"]["gamma"] = gamma.astype(np.float32)
        return params

    def reference(self, gamma):
        init_params = jax.tree.map(jax.numpy.asarray, self.params(gamma))

        def build(key, compressor, comp_cfg):
            bundle = self.jbuild(key, compressor, comp_cfg)
            if compressor == "mpe_search":
                bundle.update(params=init_params)
            return bundle
        return j_run_mpe_pipeline(build, self.jds.batch,
                                  key=jax.random.PRNGKey(4), mpe_cfg=self.jmpe,
                                  optimizer=jadam(1e-3), **self.kw)

    def port(self, gamma):
        carried = model_from_numpy(self.params(gamma),
                                   np_tree(self.init["state"]),
                                   np_tree(self.init["buffers"]),
                                   self.cfg._replace(comp_cfg=self.jmpe._asdict()),
                                   "cpu")

        def build(seed, compressor, comp_cfg):
            bundle = self.port_build(seed, compressor, comp_cfg)
            if compressor == "mpe_search":     # start from the reference's init
                bundle.update(params=carried[0], state=carried[1],
                              buffers=carried[2])
            return bundle
        data = SyntheticCTR(CTRSpec(**self.spec._asdict()))
        return run_mpe_pipeline(build, data.batch, seed=4,
                                mpe_cfg=MPEConfig(group_size=16, lam=LAM),
                                optimizer=adam(1e-3), **self.kw)

    @property
    def gamma_shape(self):
        return self.init["params"]["embedding"]["gamma"].shape


def test_pipeline_from_carried_init_matches_reference():
    both = _CarriedPipelines()
    gamma = 0.01 * np.random.default_rng(4).normal(0, 1, both.gamma_shape)
    want, got = both.reference(gamma), both.port(gamma)
    np.testing.assert_array_equal(got["group_bits"], want["group_bits"])
    np.testing.assert_array_equal(got["feature_bits_idx"],
                                  want["feature_bits_idx"])
    assert len(set(want["group_bits"].tolist())) > 1      # widths differ
    assert got["avg_bits"] == want["avg_bits"]
    t_want = want["packed_table"]
    # the port's export of the reference's final parameters: byte-identical
    fp = {k: torch.from_numpy(np.asarray(v))
          for k, v in want["final_params"]["embedding"].items()}
    t_same, _ = build_packed_table(fp["emb"], torch.from_numpy(
        want["feature_bits_idx"]), fp["alpha"], fp["beta"], MPEConfig(
            group_size=16, lam=LAM))
    assert_same_table(t_same, t_want)
    # each package's own table: the same layout, codes within one step
    t_got = got["packed_table"]
    for k in ("local_idx", "width_idx"):
        np.testing.assert_array_equal(t_got[k].numpy(), np.asarray(t_want[k]))
    # α and β: Adam moves them by up to lr = 1e-3 a step
    for k in ("alpha", "beta"):
        np.testing.assert_allclose(t_got[k].numpy(), np.asarray(t_want[k]),
                                   rtol=1e-4, atol=1e-6)
    assert got["packed_bytes"] == want["packed_bytes"]
    n_codes = n_off = 0
    for k, words in t_want["subtables"].items():
        b = int(k[1:])
        mine = unpack_codes(t_got["subtables"][k], b, 16)
        ref = unpack_codes(torch.from_numpy(np.asarray(words).view(np.int32)),
                           b, 16)
        assert int((mine - ref).abs().max()) <= 1
        n_codes += ref.numel()
        n_off += int((mine != ref).sum())
    assert n_off <= 1e-3 * n_codes
    assert [h["step"] for h in got["search_history"]] == list(range(6))
    assert [h["step"] for h in got["retrain_history"]] == list(range(4))


def test_pipeline_from_default_init_agrees_as_the_reference_with_itself():
    """γ = 0, the init the port's main path uses. The port and the reference
    sample the same width for 95 of 100 groups; the reference from a γ that
    moves p by at most two float32 steps agrees with itself on 97."""
    both = _CarriedPipelines()
    zero = np.zeros(both.gamma_shape)
    want, got = both.reference(zero), both.port(zero)
    agree = np.mean(got["group_bits"] == want["group_bits"])
    assert agree >= 0.9
    np.testing.assert_array_equal(
        got["feature_bits_idx"],
        np.asarray(got["group_bits"])[both.init["buffers"]["embedding"][
            "group_of_feature"]])
    nudge = 1e-10 * np.random.default_rng(0).normal(0, 1, both.gamma_shape)
    p = jax.nn.softmax(nudge.astype(np.float32) / MPEConfig().tau, axis=-1)
    step = np.spacing(np.float32(1 / 7))
    assert np.abs(np.asarray(p) - np.float32(1 / 7)).max() <= 2 * step
    assert np.mean(np.asarray(p) != np.float32(1 / 7)) > 0.4
    again = both.reference(nudge)
    self_agree = np.mean(again["group_bits"] == want["group_bits"])
    assert 0.9 <= self_agree < 1.0          # the reference flips some groups
    assert abs(agree - self_agree) <= 0.05  # about as many as the port does


@pytest.fixture(scope="module")
def pipeline_result():
    """The spec of ``tests/test_system.py``, on the port."""
    spec = CTRSpec(field_vocabs=(1500, 800, 2000, 600), batch_size=1024, seed=0)
    ds = SyntheticCTR(spec)
    fields = tuple(FieldSpec(f"f{i}", v) for i, v in enumerate(spec.field_vocabs))
    base = DLRMConfig(fields=fields, d_embed=16, mlp_hidden=(32, 16),
                      backbone="dnn")
    build = dlrm_builder(base, ds.expected_frequencies(), lam=LAM,
                         eval_batches=ds.eval_set(2), device="cpu")
    res = run_mpe_pipeline(
        build, ds.batch, seed=1, mpe_cfg=MPEConfig(lam=LAM),
        optimizer=adam(1e-3), search_steps=80, retrain_steps=80,
        retrain_mode="mpe", eval_fn=build(1, "plain", {})["eval_fn"],
        log_fn=lambda *a: None)
    res["_ds"], res["_build"] = ds, build
    return res


def test_pipeline_compresses(pipeline_result):
    assert pipeline_result["storage_ratio"] < 6 / 32
    assert pipeline_result["avg_bits"] < 6.0


def test_pipeline_accuracy_sane(pipeline_result):
    assert pipeline_result["eval"]["auc"] > 0.70


def test_bits_correlate_with_frequency(pipeline_result):
    gb = pipeline_result["group_bits"].astype(np.float64)
    g = len(gb)
    assert g >= 4
    assert gb[: g // 2].mean() >= gb[g // 2:].mean()


def test_packed_export_matches_model(pipeline_result):
    res = pipeline_result
    fp = res["final_params"]["embedding"]
    ids = torch.arange(100)
    deq = packed_lookup(res["packed_table"], res["packed_meta"], ids)
    rp, rb = MPERetrainEmbedding.init(fp["emb"], fp["alpha"], fp["beta"],
                                      torch.from_numpy(res["feature_bits_idx"]))
    ref = MPERetrainEmbedding.lookup(rp, rb, ids, MPEConfig(lam=LAM))
    np.testing.assert_allclose(deq.numpy(), ref.detach().numpy(), atol=1e-6)


def test_packed_bytes_match_ratio(pipeline_result):
    res = pipeline_result
    n, d = res["packed_meta"]["n"], res["packed_meta"]["d"]
    assert res["packed_bytes"] <= res["storage_ratio"] * n * d * 4 * 1.6 + 4096


def test_retraining_mode_none_is_evaluable(pipeline_result):
    ds, build = pipeline_result["_ds"], pipeline_result["_build"]
    res0 = run_mpe_pipeline(
        build, ds.batch, seed=1, mpe_cfg=MPEConfig(lam=LAM),
        optimizer=adam(1e-3), search_steps=30, retrain_steps=0,
        retrain_mode="none", eval_fn=build(1, "plain", {})["eval_fn"],
        log_fn=lambda *a: None)
    assert "auc" in res0["eval"]
    assert res0["retrain_history"] == []


def test_retraining_mode_lth_resets_every_param(pipeline_result):
    """"lth" resets every parameter, the MLP too, to its initial value
    (here with no retrain step, the exported parameters are the init)."""
    ds, build = pipeline_result["_ds"], pipeline_result["_build"]
    cfg = MPEConfig(lam=LAM)
    res = run_mpe_pipeline(
        build, ds.batch, seed=1, mpe_cfg=cfg, optimizer=adam(1e-3),
        search_steps=3, retrain_steps=0, retrain_mode="lth",
        log_fn=lambda *a: None)
    init = build(1, "mpe_search", cfg._asdict())["params"]
    for k in ("emb", "alpha", "beta"):
        assert torch.equal(res["final_params"]["embedding"][k],
                           init["embedding"][k])
    def kernel(params):
        return params["mlp"]["layers"][0]["kernel"]
    assert torch.equal(kernel(res["final_params"]), kernel(init))
    assert not torch.equal(kernel(res["search_params"]), kernel(init))


@pytest.mark.parametrize("retrain_steps", [0, 2])
def test_pipeline_snapshots_are_unchanged_by_the_trainers(pipeline_result,
                                                          retrain_steps):
    """The search trainer updates the tree ``build`` hands it in place. The
    pipeline's host snapshot of the initial parameters is what "mpe" resets
    the table to (with no retrain step the exported table is the init's),
    and its snapshot of the search results is what the search left, which
    the retrain phase does not touch."""
    ds, build = pipeline_result["_ds"], pipeline_result["_build"]
    cfg = MPEConfig(lam=LAM)
    handed = {}

    def spy(seed, compressor, comp_cfg):
        bundle = build(seed, compressor, comp_cfg)
        if compressor == "mpe_search":
            handed.update(bundle["params"]["embedding"])
        return bundle
    res = run_mpe_pipeline(
        spy, ds.batch, seed=1, mpe_cfg=cfg, optimizer=adam(1e-3),
        search_steps=3, retrain_steps=retrain_steps, retrain_mode="mpe",
        log_fn=lambda *a: None)
    init = build(1, "mpe_search", cfg._asdict())["params"]["embedding"]
    searched, final = (res["search_params"]["embedding"],
                       res["final_params"]["embedding"])
    assert not torch.equal(handed["emb"], init["emb"])   # trained in place
    for k in ("emb", "gamma", "alpha", "beta"):
        assert torch.equal(searched[k], handed[k])
    assert torch.equal(final["emb"], init["emb"]) == (retrain_steps == 0)
    assert torch.equal(final["alpha"], searched["alpha"]) == (
        retrain_steps == 0)


def test_training_launcher_on_the_cpu(capsys):
    res = launch_train.main(["--reduced", "--device", "cpu", "--steps", "3",
                             "--retrain-steps", "2", "--batch", "128"])
    out = capsys.readouterr().out
    assert "[train] MPE ratio=" in out and "auc" in res["eval"]
    assert len(res["search_history"]) == 3 and len(res["retrain_history"]) == 2
    plain = launch_train.main(["--reduced", "--device", "cpu", "--steps", "2",
                               "--batch", "128", "--compressor", "plain"])
    assert plain["storage_ratio"] == 1.0 and len(plain["history"]) == 2
    qr = launch_train.main(["--reduced", "--device", "cpu", "--steps", "2",
                            "--batch", "128", "--compressor", "qr"])
    assert 0.5 < qr["storage_ratio"] < 0.51 and len(qr["history"]) == 2
    with pytest.raises(SystemExit, match="unknown --compressor"):
        launch_train.main(["--reduced", "--device", "cpu", "--compressor", "sq"])


def test_training_launcher_needs_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_train.main(["--reduced", "--steps", "1"])
