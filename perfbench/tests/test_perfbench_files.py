"""BENCHMARK.json and the files it names: everything the harness finds by
name is there, and the contract's rules on names, bounds and cells hold."""

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
HERE = ROOT / "perfbench"
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
DRIVERS = {p.stem for p in (HERE / "drivers").glob("*.py") if p.stem != "__init__"}


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"]
    assert len(BENCH["command"]) <= 32
    for word in BENCH["command"]:
        assert not word.startswith("/") and ".." not in word
    assert (ROOT / BENCH["command"][1]).is_file()


def test_run_seconds_fits_a_full_check_of_24_cells():
    rs = BENCH["run_seconds"]
    assert 1 <= rs <= 51
    runs = 2 + 14 * 24
    assert runs * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_uniqueness():
    names = {}
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        seen = [e["name"] for e in BENCH[group]]
        assert len(seen) == len(set(seen)), group
        for n in seen:
            assert NAME.match(n), n
        names[group] = set(seen)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert not names["end_to_end"] & names["per_layer"]


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_config_file_and_reduced_keys(entry):
    path = ROOT / entry["file"]
    assert path.is_file() and entry["file"].startswith("perfbench/")
    cfg = json.loads(path.read_text())
    assert cfg["source"] == entry["source"]
    assert set(entry["reduced"]) == set(cfg["reduced"])
    assert any(w["config"] == entry["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("path", sorted((HERE / "workloads").glob("*.json")), ids=lambda p: p.stem)
def test_every_workload_file_names_a_driver_and_a_config(path):
    wl = json.loads(path.read_text())
    assert wl["driver"] in DRIVERS
    assert (HERE / "configs" / f"{wl['config']}.json").is_file()
    assert wl["chips"] in (1, 4) and 1 <= len(wl["why"]) <= 200


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda c: c["name"])
def test_cell_files_and_metrics(cell):
    from perfbench import harness

    wl = json.loads((HERE / "workloads" / f"{cell['name']}.json").read_text())
    assert wl["config"] == cell["config"] and wl["chips"] == cell["chips"] == 1
    assert "\n" not in cell["why"] and len(cell["why"]) <= 200
    e2e = {m["name"] for m in harness.cell_metrics(BENCH, cell["name"], False)}
    assert "setup_s" in e2e and len(e2e) >= 2
    per_layer = harness.cell_metrics(BENCH, cell["name"], True)
    assert per_layer
    for m in per_layer:
        assert m["moves"] in e2e
    limits = json.loads((HERE / "limits" / f"{cell['name']}.json").read_text())
    for name, lim in limits.items():
        assert isinstance(lim["limit"], (int, float)), name


def test_every_metric_has_a_reader_and_moves_an_end_to_end_metric():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
        assert (HERE / "metrics" / f"{m['name']}.py").is_file()
    cells = {c["name"] for c in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert (HERE / "metrics" / f"{m['name']}.py").is_file()
        assert m["moves"] in e2e
        assert set(m.get("workloads", [])) <= cells
        for c in m.get("workloads", []):
            assert c in e2e[m["moves"]].get("workloads", [c])
    layers = {}
    for m in BENCH["per_layer"]:
        layers.setdefault(m["layer"], []).append(m["name"])
    assert all("\n" not in layer for layer in layers)


def test_files_under_paths_are_named_from_name_characters():
    for p in HERE.rglob("*"):
        if "__pycache__" in p.parts or p.is_dir():
            continue
        rel = p.relative_to(ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel
