"""``BENCHMARK.json`` against the contract's forms, and every file it names
found where the harness looks for it."""
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "perfbench"
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PER_LAYER = [m["name"] for m in MANIFEST["per_layer"]]
CELLS = [w["name"] for w in MANIFEST["workloads"]]


def test_top_level_keys_and_command():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert MANIFEST["command"][:2] == ["python3", "perfbench/run.py"]
    assert MANIFEST["paths"] == ["perfbench"]
    assert 1 <= MANIFEST["run_seconds"] <= 51
    assert len(json.dumps(MANIFEST)) < 64 * 1024


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end",
                                  "per_layer"])
def test_names_and_units(kind):
    names = [e["name"] for e in MANIFEST[kind]]
    assert len(set(names)) == len(names)
    for e in MANIFEST[kind]:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for text in (e.get("why"), e.get("layer"), e.get("source")):
            if text is not None:
                assert 1 <= len(text) <= 200 and "\n" not in text
                assert "\t" not in text


def test_bounds():
    for m in MANIFEST["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25, m
    assert "setup_s" in {m["name"] for m in MANIFEST["end_to_end"]}


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    """The files the harness finds by the cell's name: its workload, its
    configuration, its traffic driver, the program's side of its model and
    the model's reference."""
    w = json.loads((BENCH / "workloads" / f"{cell}.json").read_text())
    cfg = json.loads((BENCH / "configs" / f"{w['config']}.json").read_text())
    for path in (BENCH / "traffic" / f"{w['driver']}.py",
                 BENCH / "models" / f"{cfg['model']}.py",
                 BENCH / "reference" / f"{cfg['model']}.py"):
        assert path.exists(), path
    entry = next(e for e in MANIFEST["workloads"] if e["name"] == cell)
    assert {k: w[k] for k in ("name", "config", "traffic", "chips",
                              "why")} == entry
    assert entry["chips"] in (1, 4)
    assert set(w["limits"]) and all(v >= 0 for v in w["limits"].values())


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_reports_enough(cell):
    from perfbench import harness
    e2e, layer = harness.cell_metrics(MANIFEST, cell)
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2 and layer
    for m in layer:
        assert m["moves"] in names


@pytest.mark.parametrize("metric", PER_LAYER)
def test_reader_declares_what_the_manifest_says(metric):
    """Each per-layer metric has a reader, found by its name; what the
    metric is (unit, layer, what it moves, its cells) is said in
    ``BENCHMARK.json`` alone, and the cells it lists report what it
    moves."""
    from perfbench import harness
    entry = next(m for m in MANIFEST["per_layer"] if m["name"] == metric)
    assert callable(harness.reader(metric).read)
    assert entry["moves"] in {m["name"] for m in MANIFEST["end_to_end"]}
    for cell in entry.get("workloads", []):
        assert cell in CELLS
        e2e, _ = harness.cell_metrics(MANIFEST, cell)
        assert entry["moves"] in {m["name"] for m in e2e}
    if "roofline" in metric or "mfu" in metric:
        assert entry["unit"] == "%"


@pytest.mark.parametrize("config", [c["name"] for c in MANIFEST["configs"]])
def test_config_files(config):
    entry = next(c for c in MANIFEST["configs"] if c["name"] == config)
    cfg = json.loads((ROOT / entry["file"]).read_text())
    assert cfg["name"] == config and cfg["source"] == entry["source"]
    assert cfg["reduced"] == entry["reduced"]
    assert (BENCH / "reference" / f"{cfg['model']}.py").exists()
    assert any(w["config"] == config for w in MANIFEST["workloads"])
