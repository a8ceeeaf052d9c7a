"""The launchers on a mesh of gloo ranks on the CPU.

``python -m torch.distributed.run --standalone --nproc-per-node 4`` starts
four ranks of ``repro_torch.launch.serve`` (or ``.train``), which read
their rank, world and coordinator from the environment through
``init_distributed``. Serving on ``--mesh 2,2`` (psum, and a2a at a
capacity that spills) must give rank 0 the scores of the run without a
mesh, bit for bit; training on ``--mesh 2,2`` must print its lookup check
as ``bit_exact=True``. ``--mesh`` fails loudly on garbage and on a mesh
larger than the world.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train

ROOT = Path(__file__).resolve().parents[1]
SERVE_ARGS = ["--reduced", "--device", "cpu", "--requests", "3", "--batch",
              "40", "--p99-rows", "64", "--bulk-rows", "256", "--bulk", "500"]
WALL_S = 180


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def torchrun(module: str, args: list[str]) -> str:
    """Four ranks of ``module`` → their stdout; raises when one fails."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        env.pop(var, None)
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "4", "-m", module, *args],
        env=env, capture_output=True, text=True, timeout=WALL_S, cwd=ROOT)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return proc.stdout


@pytest.fixture(scope="module")
def single_scores(tmp_path_factory):
    path = tmp_path_factory.mktemp("single") / "scores.npz"
    launch_serve.main(SERVE_ARGS + ["--scores", str(path)])
    return dict(np.load(path))


@pytest.mark.parametrize("comms", [["--lookup-comms", "psum"],
                                   ["--lookup-comms", "a2a",
                                    "--bucket-capacity", "4"]])
def test_serve_on_a_mesh_gives_the_single_device_scores(comms, tmp_path,
                                                        single_scores):
    path = tmp_path / "scores.npz"
    out = torchrun("repro_torch.launch.serve",
                   SERVE_ARGS + ["--mesh", "2,2", "--scores", str(path),
                                 "--json", str(tmp_path / "serve.json")]
                   + comms)
    assert out.count("[serve] mesh: {'data': 2, 'model': 2}") == 4
    got = dict(np.load(path))
    assert set(got) == set(single_scores) and "bulk" in got
    for key, want in single_scores.items():
        np.testing.assert_array_equal(got[key], want, err_msg=key)


def test_train_on_a_mesh_checks_its_lookup_bit_exact():
    out = torchrun("repro_torch.launch.train",
                   ["--reduced", "--device", "cpu", "--mesh", "2,2",
                    "--steps", "2", "--batch", "256", "--lookup-comms",
                    "a2a", "--bucket-capacity", "8"])
    # the four ranks share one pipe: a rank's line may run on into
    # another's, so each check is found by its pattern, not by its line
    checks = re.findall(r"lookup check \(a2a\): bit_exact=(\w+) "
                        r"capacity=\d+ routed=\d+ bucketed=\d+ "
                        r"spilled=\d+", out)
    assert checks == ["True"] * 4, out[-2000:]


@pytest.mark.parametrize("main", [launch_serve.main, launch_train.main])
def test_mesh_flag_rejects_garbage_and_a_mesh_larger_than_the_world(main):
    base = ["--reduced", "--device", "cpu"]
    with pytest.raises(SystemExit, match="--mesh expects"):
        main(base + ["--mesh", "two,two"])
    with pytest.raises(SystemExit, match="needs 4 ranks, 1 running"):
        main(base + ["--mesh", "2,2"])
