"""No file the benchmark runs imports the JAX stack or the JAX package the
port was made from (top-level names compared whole, so that
``repro_torch`` passes), and the plain reference imports nothing of the
program."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
FILES = sorted(BENCH.rglob("*.py"))


def imported(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


def top(name: str) -> str:
    return name.split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax(path):
    assert not {top(n) for n in imported(path)} & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py"))
                         + sorted((BENCH / "lib").glob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_reference_imports_nothing_of_the_program(path):
    for name in imported(path):
        assert top(name) != "repro_torch", name
        if top(name) == "perfbench":
            assert name.split(".")[1] in ("reference", "lib"), name


def test_the_check_tells_the_port_from_the_jax_package():
    assert top("repro_torch.models") not in FORBIDDEN
    assert top("repro.models") in FORBIDDEN


def test_a_run_loads_no_jax():
    """What a run imports, the program with it, in a fresh process: the
    harness's own look at ``sys.modules`` finds none of them."""
    root = BENCH.parent
    code = ("import perfbench.harness as h, perfbench.traffic.train_steps, "
            "perfbench.traffic.open_loop, perfbench.traffic.closed_loop, "
            "perfbench.models.dlrm, perfbench.models.bst; "
            "print(h.forbidden_modules())")
    env = dict(os.environ, PYTHONPATH=f"{root}{os.pathsep}{root / 'src'}")
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=root,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
