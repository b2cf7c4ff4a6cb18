"""BENCHMARK.json against the benchmark's contract, and every cell's files
found by name."""

import json
import re

import pytest

from conftest import BENCH, ROOT
from harness import manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCHMARK = manifest.load(ROOT)


def test_top_level_keys():
    assert set(BENCHMARK) == {"command", "paths", "run_seconds", "configs",
                              "workloads", "end_to_end", "per_layer"}
    assert BENCHMARK["paths"] == ["gsbench"]
    assert 1 <= BENCHMARK["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert all(not w.startswith("/") and ".." not in w for w in BENCHMARK["command"])


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_units_and_text(kind):
    names = [e["name"] for e in BENCHMARK[kind]]
    assert len(set(names)) == len(names)
    for e in BENCHMARK[kind]:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key]


def test_each_cell_finds_its_files():
    for cell in BENCHMARK["workloads"]:
        assert cell["chips"] == 1
        cfg = manifest.config(BENCHMARK, cell["config"])
        assert cfg["name"] == cell["config"]
        assert manifest.traffic(cell["traffic"])["name"] == cell["traffic"]
        limits = manifest.limits(cell["name"])
        assert limits and all(v > 0 for v in limits.values())
        assert any(m["name"] == "setup_s" for m in manifest.metrics(BENCHMARK, cell["name"], False))
        assert len(manifest.metrics(BENCHMARK, cell["name"], False)) >= 2
        assert manifest.metrics(BENCHMARK, cell["name"], True)


def test_configs_keep_published_widths():
    for entry in BENCHMARK["configs"]:
        cfg = json.loads((ROOT / entry["file"]).read_text())
        assert entry["file"].startswith("gsbench/")
        assert entry["reduced"] == cfg["reduced"] == []
        assert cfg["sh_degree"] == 3 and cfg["floats_per_gaussian"] == 59
        assert cfg["eval_holdout"] == 8


def test_per_layer_metrics_move_one_reported_metric():
    e2e = {m["name"]: m for m in BENCHMARK["end_to_end"]}
    cells = {c["name"] for c in BENCHMARK["workloads"]}
    layers = {}
    for m in BENCHMARK["per_layer"]:
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= cells
        for cell in m["workloads"]:
            assert cell in e2e[m["moves"]].get("workloads", [cell])
        assert (BENCH / "metrics" / f"{m['name']}.py").exists()
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


def test_bounds():
    for m in BENCHMARK["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert next(m for m in BENCHMARK["end_to_end"] if m["name"] == "setup_s")["bound"] <= 0.25


def test_a_full_check_fits_with_24_cells():
    seconds = BENCHMARK["run_seconds"]
    assert (2 + 14 * 24) * (seconds + 60) + 24 * 2 * 90 + 1200 <= 43200
