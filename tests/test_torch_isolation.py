"""The port stands alone: no module of ``repro_torch`` (the LM's and the
static checker's too), nor ``chip_smoke.py``, nor
``scripts/staticcheck_torch.py``, nor the examples' twins
``examples/*_torch.py``, imports JAX or the JAX package, and the chip smoke run refuses to report without a CUDA card or
outside the repository."""
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
TWINS = sorted((ROOT / "examples").glob("*_torch.py"))
FORBIDDEN = re.compile(r"^\s*(?:import|from)\s+(?:jax|jaxlib|repro)(?:\.|\s|$)",
                       re.MULTILINE)

_IMPORT_ALL = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               'repro_torch.')]
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules
                if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))
print(len(names))
print(leaked)
print(sorted(names))
"""


def _env(**extra):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), **extra)
    return env


# the training path's modules (schedules, checkpoints, error feedback,
# prefetch, the Table-3 baselines, Wide & Deep): each is imported by the
# walk below and read by the source check
TRAINING_PATH = ("train.optimizer", "train.checkpoint", "train.compression",
                 "train.loop", "data.loader", "cache.prefetch",
                 "core.pipeline", "core.baselines.lsq_uniform",
                 "core.baselines.alpt", "core.baselines.qr_trick",
                 "core.baselines.pep", "core.baselines.optfs",
                 "models.wide_deep", "configs.wide_deep", "zoo",
                 "launch.train", "launch.serve")


# the serving stack's modules (queue, scheduler, clocks, the graph cell
# cache, cells, repack, the socket server)
SERVING_PATH = ("serve.clock", "serve.queue", "serve.stats", "serve.batcher",
                "serve.cells", "serve.cache", "serve.scheduler",
                "serve.engine", "serve.repack", "launch.server")


# the tiered cache's modules (the store, the policy, the frequency split,
# the cold-fill kernel)
TIERED_PATH = ("embeddings.frequency", "cache.tiers", "cache.policy",
               "kernels.tiered_cold.ops", "kernels.tiered_cold.ref")


# two-tower retrieval, GIN and its graphs, the Criteo loader, the tree
# utilities
MODEL_PATH = ("nn.module", "models.two_tower", "configs.two_tower_retrieval",
              "models.gnn.gin", "configs.gin_tu", "data.graphs",
              "data.criteo")


# the LM's serving path: its layers, model, tokens, configs and the two
# decode kernels
LM_PATH = ("nn.rope", "nn.chunked", "nn.moe", "models.lm.transformer",
           "data.tokens", "configs.internlm2_1_8b", "configs.qwen3_32b",
           "configs.starcoder2_7b", "configs.deepseek_moe_16b",
           "configs.grok_1_314b", "kernels.kv_cache_write.ops",
           "kernels.kv_cache_write.ref", "kernels.decode_attention.ops",
           "kernels.decode_attention.ref")


# the distribution layer: the mesh, the placement contract, the sharded
# kernels and train step, the production mesh
DIST_PATH = ("dist.mesh", "dist.sharding", "dist.shard", "launch.mesh")


# the tooling: the static contract checker, the kernels' region marker,
# the dry-run cells and their per-device trace analysis
TOOLING_PATH = ("analysis.findings", "analysis.lint", "analysis.op_walk",
                "analysis.precision", "analysis.recompile",
                "analysis.shardspec", "analysis.budgets", "analysis.corpus",
                "analysis.runner", "kernels.region", "launch.cells",
                "launch.dryrun", "launch.trace_analysis")


def test_training_path_modules_are_in_the_port():
    for name in (TRAINING_PATH + SERVING_PATH + TIERED_PATH + MODEL_PATH
                 + LM_PATH + DIST_PATH + TOOLING_PATH):
        assert (PORT / (name.replace(".", "/") + ".py")).is_file(), name


def test_every_port_module_imports_without_jax_or_reference():
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL], env=_env(),
                          capture_output=True, text=True, timeout=300,
                          cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    n_modules, leaked, names = proc.stdout.strip().splitlines()[-3:]
    assert int(n_modules) >= 25 + len(TRAINING_PATH) + len(SERVING_PATH) \
        + len(TIERED_PATH) + len(MODEL_PATH) + len(LM_PATH) + len(DIST_PATH) \
        + len(TOOLING_PATH)
    assert leaked == "[]"
    for name in (TRAINING_PATH + SERVING_PATH + TIERED_PATH + MODEL_PATH
                 + LM_PATH + DIST_PATH + TOOLING_PATH):
        assert f"'repro_torch.{name}'" in names, name


@pytest.mark.parametrize("path", sorted(str(p.relative_to(ROOT)) for p in
                                        [*PORT.rglob("*.py"), *TWINS,
                                         ROOT / "chip_smoke.py",
                                         ROOT / "scripts" /
                                         "staticcheck_torch.py"]))
def test_source_names_no_jax_or_reference_import(path):
    text = (ROOT / path).read_text()
    assert FORBIDDEN.findall(text) == []
    assert "import jax" not in text


_IMPORT_TWIN = """
import importlib.util, sys
spec = importlib.util.spec_from_file_location('twin', sys.argv[1])
module = importlib.util.module_from_spec(spec)
spec.loader.exec_module(module)
assert callable(module.main)
print(sorted(m for m in sys.modules
             if m.split('.')[0] in ('jax', 'jaxlib', 'repro')))
"""


def test_the_examples_have_their_twins():
    names = {p.name for p in TWINS}
    assert names == {"quickstart_torch.py", "serve_packed_torch.py",
                     "train_ctr_end_to_end_torch.py",
                     "gnn_molecule_mpe_torch.py", "lm_vocab_mpe_torch.py"}


@pytest.mark.parametrize("twin", [p.name for p in TWINS])
def test_an_example_twin_imports_without_jax_or_reference(twin):
    proc = subprocess.run(
        [sys.executable, "-c", _IMPORT_TWIN, str(ROOT / "examples" / twin)],
        env=_env(), capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "[]"


def test_chip_smoke_fails_without_a_card():
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                          env=_env(CUDA_VISIBLE_DEVICES=""),
                          capture_output=True, text=True, timeout=300,
                          cwd=ROOT)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_chip_smoke_fails_outside_the_repository(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "chip_smoke.py"], env=env,
                          capture_output=True, text=True, timeout=300,
                          cwd=tmp_path)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
